"""Abstract pipeline interfaces (the PyTorch port's own copy of
``twotower_tpu/data/base.py``).

Parity with the reference's contract layer (reference: src/data/base.py:35-125
— ``DataProcessor``/``DataValidator``/``DataLoader``/``DataSaver`` ABCs with
input-column validation and retention-stats logging). The concrete
implementations in this package satisfy these contracts:
``Preprocessor`` (process), ``AmazonReviewsValidator`` (validate),
``AmazonReviewsLoader`` (load), and the prepare CLI's artifact writer (save).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any

from twotower_tpu_torch.logging_utils import get_logger, log_retention

logger = get_logger(__name__)


class DataProcessor(ABC):
    """Transform interaction data (reference: base.py:35-76)."""

    @abstractmethod
    def process(self, data: Any) -> Any:
        """Run the transformation and return the processed data."""

    def validate_input(self, data: Any, required_columns: list[str]) -> None:
        """Raise if required columns are missing (reference: base.py:56-69).

        Works for both pandas DataFrames (``.columns``) and the columnar
        ``Interactions`` container (attribute presence).
        """
        if hasattr(data, "columns"):
            have = set(data.columns)
            missing = [c for c in required_columns if c not in have]
        else:
            missing = [
                c
                for c in required_columns
                if getattr(data, c, None) is None and c not in getattr(data, "extra", {})
            ]
        if missing:
            raise ValueError(f"input data missing required columns: {missing}")

    def log_processing_stats(self, stage: str, before: int, after: int) -> None:
        """Retention-stats logging (reference: base.py:71-76)."""
        log_retention(logger, stage, before, after)


class DataValidator(ABC):
    """Structural/quality validation (reference: base.py:79-93)."""

    @abstractmethod
    def validate(self, data: Any) -> Any:
        """Return a validation result; warn-only semantics by convention."""


class DataLoader(ABC):
    """Data ingestion (reference: base.py:96-110)."""

    @abstractmethod
    def load(self, *args: Any, **kwargs: Any) -> Any:
        """Load and return data."""


class DataSaver(ABC):
    """Artifact persistence (reference: base.py:113-125)."""

    @abstractmethod
    def save(self, data: Any, path: Any) -> None:
        """Persist data to ``path``."""

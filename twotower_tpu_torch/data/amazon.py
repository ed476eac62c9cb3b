"""Amazon Reviews 2023 loader: HF Hub download, parquet cache, validation (the
PyTorch port's own copy of ``twotower_tpu/data/amazon.py``, host only).

Capability parity with the reference's implemented data layer
(reference: src/data/amazon_loader.py:96-379): per-category download of the
``McAuley-Lab/Amazon-Reviews-2023`` raw configs, snappy-parquet caching with
a TTL, warn-only structural validation, deterministic sampling (seed 42),
fault-tolerant multi-category loads, category discovery, and per-category
statistics — plus the 5-core preprocessed configs path
(reference: scripts/data_processing/download_efficient.py:28-96).

The ``datasets``/``huggingface_hub`` imports are lazy: in a zero-egress
environment everything except the actual download works (and tests patch
``load_dataset`` exactly as the reference's tests do,
tests/unit/test_amazon_loader.py:65).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, TypedDict

import numpy as np

from twotower_tpu_torch.config import DatasetConfig
from twotower_tpu_torch.data.base import DataLoader, DataValidator
from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

REQUIRED_REVIEW_COLUMNS = (
    "user_id", "parent_asin", "rating", "title", "text", "timestamp",
)  # reference: amazon_loader.py:36
REQUIRED_META_COLUMNS = (
    "parent_asin", "main_category", "title", "average_rating", "rating_number",
)  # reference: amazon_loader.py:38-44

# 5-core preprocessed configs (reference: download_efficient.py:28-36).
KCORE_CONFIGS = {
    "All_Beauty": "5core_timestamp_All_Beauty",
    "Books": "5core_timestamp_Books",
    "Electronics": "5core_timestamp_Electronics",
    "Home_and_Kitchen": "5core_timestamp_Home_and_Kitchen",
    "Movies_and_TV": "5core_timestamp_Movies_and_TV",
    "Video_Games": "5core_timestamp_Video_Games",
}


class CategoryStats(TypedDict, total=False):
    """Per-category statistics (reference: amazon_loader.py:20-30)."""

    category: str
    num_reviews: int
    num_users: int
    num_items: int
    avg_rating: float
    rating_std: float
    sparsity: float
    date_range: tuple[str, str]


class ValidationResult:
    def __init__(self) -> None:
        self.errors: list[str] = []
        self.warnings: list[str] = []

    @property
    def ok(self) -> bool:
        return not self.errors

    def __repr__(self) -> str:
        return f"ValidationResult(errors={self.errors}, warnings={self.warnings})"


class AmazonReviewsValidator(DataValidator):
    """Structural/quality checks (reference: amazon_loader.py:33-93).

    Warn-only semantics like the reference: problems are logged and returned,
    nothing raises — the pipeline's later stages drop bad rows.
    """

    def validate(self, df: Any, data_type: str = "reviews") -> ValidationResult:
        result = ValidationResult()
        required = (
            REQUIRED_REVIEW_COLUMNS if data_type == "reviews" else REQUIRED_META_COLUMNS
        )
        cols = set(df.columns)
        missing = [c for c in required if c not in cols]
        if missing:
            result.errors.append(f"missing required columns: {missing}")
            for msg in result.errors:
                logger.warning("validation: %s", msg)
            return result

        if data_type == "reviews" and len(df):
            ratings = np.asarray(df["rating"], dtype=np.float64)
            bad = ~np.isnan(ratings) & ((ratings < 1) | (ratings > 5))
            if bad.any():  # reference: amazon_loader.py:67
                result.warnings.append(
                    f"{int(bad.sum())} ratings outside [1, 5]"
                )
            text = df["text"]
            empty = sum(1 for t in text if not str(t).strip() or t is None)
            if empty / len(df) > 0.10:  # reference: amazon_loader.py:74-79
                result.warnings.append(
                    f"{empty / len(df):.1%} of reviews have empty text"
                )
            pairs = list(zip(df["user_id"], df["parent_asin"]))
            dupes = len(pairs) - len(set(pairs))
            if dupes:  # reference: amazon_loader.py:88-91
                result.warnings.append(f"{dupes} duplicate (user, item) pairs")
        for msg in result.warnings:
            logger.warning("validation: %s", msg)
        return result


class AmazonReviewsLoader(DataLoader):
    """HF Hub loader with parquet cache (reference: amazon_loader.py:96-379)."""

    def __init__(self, config: DatasetConfig | None = None, cache_dir: str | None = None):
        self.config = config or DatasetConfig()
        self.cache_dir = Path(cache_dir or self.config.cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.validator = AmazonReviewsValidator()

    # ------------------------------------------------------------------
    # Cache (reference: amazon_loader.py:121-132, :172-188)
    # ------------------------------------------------------------------

    def _cache_path(self, category: str, data_type: str) -> Path:
        return self.cache_dir / f"{category}_{data_type}.parquet"

    def _cache_valid(self, path: Path) -> bool:
        if not path.exists():
            return False
        age_h = (time.time() - path.stat().st_mtime) / 3600
        return age_h < self.config.cache_max_age_hours

    # ------------------------------------------------------------------
    # Download (reference: amazon_loader.py:134-170)
    # ------------------------------------------------------------------

    def _download(self, category: str, data_type: str):
        from datasets import load_dataset  # lazy: network dependency

        config_name = f"raw_{'review' if data_type == 'reviews' else 'meta'}_{category}"
        logger.info("downloading %s/%s from HF Hub", self.config.source, config_name)
        dataset = load_dataset(
            self.config.source, config_name, trust_remote_code=True
        )
        df = dataset["full"].to_pandas()
        self.validator.validate(df, data_type)
        return df

    def load_category(
        self,
        category: str,
        data_type: str = "reviews",
        use_cache: bool = True,
        sample_size: int | None = None,
    ):
        """One category -> pandas DataFrame, via cache when fresh
        (reference: amazon_loader.py:190-227)."""
        import pandas as pd

        path = self._cache_path(category, data_type)
        if use_cache and self._cache_valid(path):
            logger.info("cache hit: %s", path)
            df = pd.read_parquet(path)
        else:
            df = self._download(category, data_type)
            df.to_parquet(path, compression="snappy")
            logger.info("cached %d rows -> %s", len(df), path)
        if sample_size is not None and len(df) > sample_size:
            # Deterministic sampling, seed from config (reference seed 42,
            # amazon_loader.py:223-225).
            df = df.sample(n=sample_size, random_state=self.config.seed)
        return df

    def load_multiple_categories(
        self,
        categories: list[str] | None = None,
        data_type: str = "reviews",
        sample_size: int | None = None,
    ) -> dict[str, Any]:
        """Fault-tolerant multi-category load
        (reference: amazon_loader.py:229-276)."""
        categories = categories or self.config.categories
        out: dict[str, Any] = {}
        for category in categories:
            try:
                out[category] = self.load_category(
                    category, data_type, sample_size=sample_size
                )
            except Exception as e:  # per-category tolerance, like reference
                logger.error("failed to load %s: %s", category, e)
        return out

    def load(self, sample_size: int | None = None):
        """All configured categories concatenated with a ``category`` column
        (test-implied API, SURVEY.md §4: reference tests expect concat)."""
        import pandas as pd

        frames = []
        for category, df in self.load_multiple_categories(
            sample_size=sample_size
        ).items():
            df = df.copy()
            df["category"] = category
            frames.append(df)
        if not frames:
            raise RuntimeError("no categories loaded")
        return pd.concat(frames, ignore_index=True)

    # ------------------------------------------------------------------
    # 5-core path (reference: download_efficient.py:48-96)
    # ------------------------------------------------------------------

    def load_kcore(self, category: str, max_rows: int | None = None):
        """Preprocessed 5-core split, train+valid+test concatenated."""
        from datasets import load_dataset
        import pandas as pd

        config_name = KCORE_CONFIGS.get(category, f"5core_timestamp_{category}")
        dataset = load_dataset(self.config.source, config_name, trust_remote_code=True)
        frames = [dataset[s].to_pandas() for s in dataset.keys()]
        df = pd.concat(frames, ignore_index=True)
        if "timestamp" in df.columns:
            df["timestamp"] = pd.to_numeric(df["timestamp"], errors="coerce")
        if max_rows is not None and len(df) > max_rows:
            df = df.sample(n=max_rows, random_state=self.config.seed)
        return df

    # ------------------------------------------------------------------
    # Discovery + stats (reference: amazon_loader.py:295-379)
    # ------------------------------------------------------------------

    def get_available_categories(self) -> list[str]:
        from huggingface_hub import HfApi

        info = HfApi().dataset_info(self.config.source)
        names = set()
        for sibling in getattr(info, "siblings", []) or []:
            name = getattr(sibling, "rfilename", "")
            if name.startswith("raw/review_categories/"):
                names.add(Path(name).stem)
        return sorted(names)

    def get_dataset_statistics(self, category: str) -> CategoryStats:
        """Per-category stats over the cached/loaded reviews frame."""
        df = self.load_category(category)
        ratings = np.asarray(df["rating"], np.float64)
        num_users = df["user_id"].nunique()
        num_items = df["parent_asin"].nunique()
        ts_raw = np.asarray(
            __import__("pandas").to_numeric(df["timestamp"], errors="coerce"),
            np.float64,
        )
        ts = ts_raw[np.isfinite(ts_raw)].astype(np.int64)
        if len(ts) and np.median(np.abs(ts)) > 1e11:
            ts = ts // 1000
        fmt = "%Y-%m-%d"
        import datetime as dt

        return CategoryStats(
            category=category,
            num_reviews=len(df),
            num_users=int(num_users),
            num_items=int(num_items),
            avg_rating=float(np.nanmean(ratings)) if len(df) else 0.0,
            rating_std=float(np.nanstd(ratings)) if len(df) else 0.0,
            sparsity=1.0 - len(df) / max(num_users * num_items, 1),
            date_range=(
                dt.datetime.fromtimestamp(int(ts.min())).strftime(fmt),
                dt.datetime.fromtimestamp(int(ts.max())).strftime(fmt),
            )
            if len(ts)
            else ("", ""),
        )

"""Columnar interaction schema (the PyTorch port's own copy of
``twotower_tpu/data/schema.py``, numpy only).

The reference keeps everything in pandas DataFrames (src/data/preprocessor.py,
prepare_training_data.py). The data plane is a struct-of-arrays
`Interactions` container: contiguous numpy columns that vectorize on host and
convert straight into fixed-shape device batches. DataFrames are accepted at
the ingestion boundary only.

Required raw columns mirror the reference validator
(src/data/amazon_loader.py:36): user_id, parent_asin, rating, timestamp
(title/text optional for metric parity — 5-core data has empty text,
prepare_training_data.py:61-63).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Iterator, Mapping

import numpy as np

REQUIRED_COLUMNS = ("user_id", "parent_asin", "rating", "timestamp")
OPTIONAL_TEXT_COLUMNS = ("title", "text")


class SchemaError(ValueError):
    """Raised when ingested data is missing required columns."""


@dataclass
class Interactions:
    """Struct-of-arrays interaction table.

    ``user_id``/``item_id`` are raw string/object ids; ``user_idx``/
    ``item_idx`` are contiguous int32 encodings (present after vocab
    encoding — the ``user_idx``/``item_idx`` naming follows the reference's
    training-prep artifact, prepare_training_data.py:209-210).
    """

    user_id: np.ndarray  # object/str
    item_id: np.ndarray  # object/str
    rating: np.ndarray  # float32
    timestamp: np.ndarray  # int64 (unix seconds or ms; normalized to seconds)
    text: np.ndarray | None = None  # object/str
    title: np.ndarray | None = None  # object/str
    user_idx: np.ndarray | None = None  # int32
    item_idx: np.ndarray | None = None  # int32
    extra: dict[str, np.ndarray] = field(default_factory=dict)

    def __post_init__(self) -> None:
        n = len(self.user_id)
        for name in ("item_id", "rating", "timestamp"):
            col = getattr(self, name)
            if len(col) != n:
                raise SchemaError(f"column {name} has length {len(col)} != {n}")

    def __len__(self) -> int:
        return len(self.user_id)

    @property
    def num_users(self) -> int:
        if self.user_idx is not None and len(self.user_idx):
            return int(self.user_idx.max()) + 1
        return len(np.unique(self.user_id))

    @property
    def num_items(self) -> int:
        if self.item_idx is not None and len(self.item_idx):
            return int(self.item_idx.max()) + 1
        return len(np.unique(self.item_id))

    @property
    def sparsity(self) -> float:
        """Fraction of the user x item matrix that is empty
        (reference: prepare_training_data.py:136)."""
        denom = self.num_users * self.num_items
        return 1.0 - (len(self) / denom) if denom else 0.0

    # ------------------------------------------------------------------

    def select(self, mask_or_index: np.ndarray) -> "Interactions":
        """Row subset by boolean mask or integer index array."""

        def take(col: np.ndarray | None) -> np.ndarray | None:
            return None if col is None else col[mask_or_index]

        return Interactions(
            user_id=self.user_id[mask_or_index],
            item_id=self.item_id[mask_or_index],
            rating=self.rating[mask_or_index],
            timestamp=self.timestamp[mask_or_index],
            text=take(self.text),
            title=take(self.title),
            user_idx=take(self.user_idx),
            item_idx=take(self.item_idx),
            extra={k: v[mask_or_index] for k, v in self.extra.items()},
        )

    def with_columns(self, **cols: np.ndarray) -> "Interactions":
        known = {f.name for f in self.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        updates: dict[str, Any] = {}
        extra = dict(self.extra)
        for name, col in cols.items():
            if len(col) != len(self):
                raise SchemaError(f"column {name} has wrong length")
            if name in known and name != "extra":
                updates[name] = col
            else:
                extra[name] = col
        return replace(self, extra=extra, **updates)

    def iter_chunks(self, chunk_size: int) -> Iterator["Interactions"]:
        for start in range(0, len(self), chunk_size):
            yield self.select(np.arange(start, min(start + chunk_size, len(self))))

    def concat(self, other: "Interactions") -> "Interactions":
        def cat_text(a, b, n_a, n_b):
            # keep text when either side has it (fill the other with "")
            if a is None and b is None:
                return None
            if a is None:
                a = np.full(n_a, "", object)
            if b is None:
                b = np.full(n_b, "", object)
            return np.concatenate([a, b])

        def cat(a: np.ndarray | None, b: np.ndarray | None) -> np.ndarray | None:
            if a is None or b is None:
                return None
            return np.concatenate([a, b])

        return Interactions(
            user_id=np.concatenate([self.user_id, other.user_id]),
            item_id=np.concatenate([self.item_id, other.item_id]),
            rating=np.concatenate([self.rating, other.rating]),
            timestamp=np.concatenate([self.timestamp, other.timestamp]),
            text=cat_text(self.text, other.text, len(self), len(other)),
            title=cat_text(self.title, other.title, len(self), len(other)),
            user_idx=cat(self.user_idx, other.user_idx),
            item_idx=cat(self.item_idx, other.item_idx),
            extra={
                k: np.concatenate([v, other.extra[k]])
                for k, v in self.extra.items()
                if k in other.extra
            },
        )


# ---------------------------------------------------------------------------
# Ingestion boundary
# ---------------------------------------------------------------------------

_COLUMN_ALIASES: Mapping[str, tuple[str, ...]] = {
    "user_id": ("user_id", "reviewerID", "user"),
    "parent_asin": ("parent_asin", "item_id", "asin", "item"),
    "rating": ("rating", "overall", "stars"),
    "timestamp": ("timestamp", "unixReviewTime", "time", "sort_timestamp"),
    "text": ("text", "reviewText", "review_text"),
    "title": ("title", "summary"),
}


def _resolve(columns: set[str], canonical: str) -> str | None:
    for alias in _COLUMN_ALIASES[canonical]:
        if alias in columns:
            return alias
    return None


def from_columns(raw: Mapping[str, Any], strict: bool = True) -> Interactions:
    """Build Interactions from a mapping of column name -> array-like.

    Normalizes dtypes the way the reference's schema normalization does
    (prepare_training_data.py:93-108): numeric coercion for rating/timestamp,
    NaN rows dropped, millisecond timestamps scaled to seconds.
    """
    cols = set(raw.keys())
    resolved: dict[str, str] = {}
    for canonical in ("user_id", "parent_asin", "rating", "timestamp"):
        name = _resolve(cols, canonical)
        if name is None:
            if strict or canonical in ("user_id", "parent_asin"):
                # ids are irreducible; rating/timestamp get lenient defaults
                raise SchemaError(
                    f"missing required column {canonical!r} (have {sorted(cols)})"
                )
            continue
        resolved[canonical] = name

    def as_array(name: str) -> np.ndarray:
        col = raw[name]
        return col.to_numpy() if hasattr(col, "to_numpy") else np.asarray(col)

    user_id = as_array(resolved["user_id"]).astype(object)
    item_id = as_array(resolved["parent_asin"]).astype(object)
    n_rows = len(user_id)
    rating = (
        _coerce_numeric(as_array(resolved["rating"]), np.float32)
        if "rating" in resolved
        else np.ones(n_rows, np.float32)  # lenient default: implicit positive
    )
    timestamp = (
        _coerce_numeric(as_array(resolved["timestamp"]), np.float64)
        if "timestamp" in resolved
        else np.zeros(n_rows, np.float64)
    )

    # Drop rows with unparseable rating/timestamp or missing ids
    # (reference: preprocessor.py:441 dropna on ids/rating).
    valid = (
        ~np.isnan(rating)
        & ~np.isnan(timestamp)
        & np.array([x is not None and x == x and str(x) != "" for x in user_id])
        & np.array([x is not None and x == x and str(x) != "" for x in item_id])
    )
    user_id, item_id = user_id[valid], item_id[valid]
    rating, timestamp = rating[valid], timestamp[valid]

    # Normalize ms → s (Amazon Reviews 2023 uses ms timestamps).
    ts = timestamp.astype(np.int64)
    if len(ts) and np.median(np.abs(ts[: min(len(ts), 100_000)])) > 1e11:
        ts = ts // 1000

    text_name = _resolve(cols, "text")
    title_name = _resolve(cols, "title")

    def text_col(name: str | None) -> np.ndarray | None:
        if name is None:
            return None
        col = as_array(name)[valid].astype(object)
        # fillna("") — reference: preprocessor.py:442-443
        return np.array(["" if (x is None or x != x) else str(x) for x in col], dtype=object)

    return Interactions(
        user_id=user_id,
        item_id=item_id,
        rating=rating.astype(np.float32),
        timestamp=ts,
        text=text_col(text_name),
        title=text_col(title_name),
    )


def from_dataframe(df: Any, strict: bool = True) -> Interactions:
    """Ingest a pandas DataFrame (the reference's native container)."""
    return from_columns({c: df[c] for c in df.columns}, strict=strict)


def _coerce_numeric(col: np.ndarray, dtype: Any) -> np.ndarray:
    if col.dtype.kind in "ifub":
        return col.astype(dtype)
    out = np.empty(len(col), dtype=np.float64)
    for i, v in enumerate(col):
        try:
            out[i] = float(v)
        except (TypeError, ValueError):
            out[i] = np.nan
    return out.astype(dtype) if dtype != np.float64 else out

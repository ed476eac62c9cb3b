"""Feature engineering: temporal, text, and aggregate features (the PyTorch
port's own copy of ``twotower_tpu/features/engineer.py``, numpy only).

Behavioral parity with the reference's ``FeatureEngineer``
(reference: src/data/preprocessor.py:221-344) re-implemented as vectorized
columnar transforms: datetime decomposition without per-row Python,
group aggregates via factorize + ``np.bincount`` (O(n), no shuffle-join —
the reference's groupby-merge is its hottest pandas path, SURVEY.md §3.3).

These features are optional for retrieval-metric parity (the id-only towers
don't consume them — reference 5-core data has empty text anyway,
prepare_training_data.py:61-63) but are part of the reference's implemented
surface and feed the optional text encoder (features/text_encoder.py).
"""

from __future__ import annotations

import numpy as np

from twotower_tpu_torch.data.schema import Interactions
from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

# len(str(x)) as a ufunc: C-dispatched per element, no interpreter loop.
_len_ufunc = np.frompyfunc(
    lambda t: len(t) if isinstance(t, str) else len(str(t)), 1, 1
)

# Lazily-grown per-codepoint Unicode property table: bit 0 = str.isspace,
# bit 1 = str.isupper — ONE fancy-index lookup serves both properties.
_PROPERTY_TABLE: np.ndarray | None = None


def _codepoint_table(max_code: int) -> np.ndarray:
    global _PROPERTY_TABLE
    table = _PROPERTY_TABLE
    if table is None or len(table) <= max_code:
        size = max(int(max_code) + 1, 1 << 16)
        table = np.fromiter(
            (
                (chr(c).isspace() | (chr(c).isupper() << 1))
                for c in range(size)
            ),
            dtype=np.uint8,
            count=size,
        )
        table[0] = 0  # NUL is the padding sentinel, never a property hit
        _PROPERTY_TABLE = table
    return table


class FeatureEngineer:
    """Columnar feature transforms; each returns a new ``Interactions`` with
    extra columns attached."""

    # ------------------------------------------------------------------
    # Temporal (reference: preprocessor.py:232-253)
    # ------------------------------------------------------------------

    def create_temporal_features(self, data: Interactions) -> Interactions:
        ts = data.timestamp.astype("datetime64[s]")
        days = ts.astype("datetime64[D]")
        years = ts.astype("datetime64[Y]")
        months = ts.astype("datetime64[M]")
        year = years.astype(np.int32) + 1970
        month = (months - years).astype(np.int32) + 1
        day = (days - months).astype(np.int32) + 1
        # 1970-01-01 was a Thursday; reference uses pandas dayofweek (Mon=0).
        day_of_week = ((days.astype(np.int64) + 3) % 7).astype(np.int32)
        hour = ((data.timestamp % 86400) // 3600).astype(np.int32)
        is_weekend = (day_of_week >= 5).astype(np.int32)
        start = data.timestamp.min() if len(data) else 0
        days_since_start = ((data.timestamp - start) // 86400).astype(np.int32)
        return data.with_columns(
            year=year,
            month=month,
            day=day,
            day_of_week=day_of_week,
            hour=hour,
            is_weekend=is_weekend,
            days_since_start=days_since_start,
        )

    # ------------------------------------------------------------------
    # Text (reference: preprocessor.py:255-274)
    # ------------------------------------------------------------------

    @staticmethod
    def _text_stats_slow(col: np.ndarray, prefix: str) -> dict[str, np.ndarray]:
        """Per-row Python reference implementation — the semantics twin the
        vectorized ``_text_stats`` is equality-tested against."""
        n = len(col)
        length = np.empty(n, np.int32)
        words = np.empty(n, np.int32)
        excl = np.empty(n, np.int32)
        ques = np.empty(n, np.int32)
        caps = np.empty(n, np.float32)
        for i, t in enumerate(col):
            t = "" if t is None else str(t)
            length[i] = len(t)
            words[i] = len(t.split())
            excl[i] = t.count("!")
            ques[i] = t.count("?")
            caps[i] = sum(c.isupper() for c in t) / max(len(t), 1)
        return {
            f"{prefix}_length": length,
            f"{prefix}_word_count": words,
            f"{prefix}_exclamation_count": excl,
            f"{prefix}_question_count": ques,
            f"{prefix}_caps_ratio": caps,
        }

    @staticmethod
    def _text_stats(
        col: np.ndarray, prefix: str, *, chunk_rows: int = 16384
    ) -> dict[str, np.ndarray]:
        """Vectorized text stats: chunked codepoint matrices + per-codepoint
        Unicode property tables (exact ``str.split``/``str.isupper``
        semantics, measured >10x the per-row loop on 1M rows).

        Each chunk is widened to a ``[rows, max_len]`` uint32 codepoint
        matrix (bounded memory via ``chunk_rows``); length, word starts,
        '!'/'?' counts and uppercase ratios are plain array reductions.
        Only caveat: embedded NUL characters count as padding (absent from
        review text by construction — data/text.py strips controls).
        """
        n = len(col)
        length = np.zeros(n, np.int32)
        words = np.zeros(n, np.int32)
        excl = np.zeros(n, np.int32)
        ques = np.zeros(n, np.int32)
        caps = np.zeros(n, np.float32)
        # None -> "" once (C-level object compare), str() conversion happens
        # inside the per-chunk astype("U") below — no Python-level per-row
        # loop anywhere on this path.
        clean = np.where(np.equal(col, None), "", col)
        lens = _len_ufunc(clean).astype(np.int64)
        # Process in length-sorted order: each chunk's matrix width is set by
        # its LONGEST row, so mixing one 2000-char review into a chunk of
        # tweets would multiply the element work ~40x.
        order = np.argsort(lens)
        for lo in range(0, n, chunk_rows):
            sel = order[lo : lo + chunk_rows]
            # Object rows -> fixed-width unicode -> uint32 codepoints.
            width = int(lens[sel[-1]])
            as_u = clean[sel].astype(f"U{max(width, 1)}")
            if width == 0:  # all-empty chunk
                continue
            codes = as_u.view(np.uint32).reshape(len(sel), width)
            present = codes != 0
            row_len = present.sum(axis=1, dtype=np.int32)
            length[sel] = row_len
            excl[sel] = (codes == ord("!")).sum(axis=1, dtype=np.int32)
            ques[sel] = (codes == ord("?")).sum(axis=1, dtype=np.int32)
            props = _codepoint_table(codes.max())[codes]
            token = present & ~(props & 1).astype(bool)
            # Word starts: a token position whose predecessor is not a token.
            starts = token.copy()
            starts[:, 1:] &= ~token[:, :-1]
            words[sel] = starts.sum(axis=1, dtype=np.int32)
            caps[sel] = (props >> 1).sum(axis=1, dtype=np.int32) / np.maximum(
                row_len, 1
            )
        return {
            f"{prefix}_length": length,
            f"{prefix}_word_count": words,
            f"{prefix}_exclamation_count": excl,
            f"{prefix}_question_count": ques,
            f"{prefix}_caps_ratio": caps,
        }

    def create_text_features(self, data: Interactions) -> Interactions:
        cols: dict[str, np.ndarray] = {}
        if data.text is not None:
            cols.update(self._text_stats(data.text, "text"))
        if data.title is not None:
            cols.update(self._text_stats(data.title, "title"))
        return data.with_columns(**cols) if cols else data

    # ------------------------------------------------------------------
    # Aggregates (reference: preprocessor.py:276-344): factorize + bincount
    # ------------------------------------------------------------------

    @staticmethod
    def _group_stats(codes: np.ndarray, values: np.ndarray, n_groups: int):
        """Per-group count/mean/std/min/max in O(n)."""
        count = np.bincount(codes, minlength=n_groups).astype(np.float64)
        safe = np.maximum(count, 1)
        s1 = np.bincount(codes, weights=values, minlength=n_groups)
        mean = s1 / safe
        s2 = np.bincount(codes, weights=values**2, minlength=n_groups)
        var = np.maximum(s2 / safe - mean**2, 0.0)
        std = np.sqrt(var)
        gmin = np.full(n_groups, np.inf)
        np.minimum.at(gmin, codes, values)
        gmax = np.full(n_groups, -np.inf)
        np.maximum.at(gmax, codes, values)
        return count, mean, std, gmin, gmax

    def _aggregate(self, data: Interactions, key: np.ndarray, prefix: str) -> Interactions:
        _, codes = np.unique(key.astype(str), return_inverse=True)
        n_groups = codes.max() + 1 if len(codes) else 0
        ratings = data.rating.astype(np.float64)
        count, mean, std, gmin, gmax = self._group_stats(codes, ratings, n_groups)
        cols = {
            f"{prefix}_rating_count": count[codes].astype(np.int32),
            f"{prefix}_rating_mean": mean[codes].astype(np.float32),
            f"{prefix}_rating_std": std[codes].astype(np.float32),
            f"{prefix}_rating_min": gmin[codes].astype(np.float32),
            f"{prefix}_rating_max": gmax[codes].astype(np.float32),
        }
        if "text_length" in data.extra:
            tl = data.extra["text_length"].astype(np.float64)
            _, t_mean, _, _, _ = self._group_stats(codes, tl, n_groups)
            cols[f"{prefix}_text_length_mean"] = t_mean[codes].astype(np.float32)
        return data.with_columns(**cols)

    def create_user_features(self, data: Interactions) -> Interactions:
        return self._aggregate(data, data.user_id, "user")

    def create_item_features(
        self, data: Interactions, meta: dict[str, np.ndarray] | None = None
    ) -> Interactions:
        """Item aggregates + optional metadata join on item id
        (reference: preprocessor.py:307-344 joins main_category,
        average_rating, rating_number from the meta table)."""
        data = self._aggregate(data, data.item_id, "item")
        if meta is not None:
            if "parent_asin" not in meta:
                raise ValueError("meta must contain parent_asin for the join")
            meta_ids = np.asarray(meta["parent_asin"], object).astype(str)
            lookup = {mid: i for i, mid in enumerate(meta_ids)}
            rows = np.array(
                [lookup.get(str(i), -1) for i in data.item_id], np.int64
            )
            found = rows >= 0
            for name in ("main_category", "average_rating", "rating_number"):
                if name not in meta:
                    continue
                src = np.asarray(meta[name])
                if src.dtype.kind in "ifub":
                    col = np.full(len(data), np.nan, np.float64)
                    col[found] = src[rows[found]].astype(np.float64)
                else:
                    col = np.full(len(data), "", object)
                    col[found] = src[rows[found]]
                data = data.with_columns(**{f"item_{name}": col})
        return data

    # ------------------------------------------------------------------

    def engineer_features(
        self, data: Interactions, meta: dict[str, np.ndarray] | None = None
    ) -> Interactions:
        """All feature groups (reference: preprocessor.py:464-476; public
        name follows the test-implied API, SURVEY.md §4)."""
        before_cols = len(data.extra)
        data = self.create_temporal_features(data)
        data = self.create_text_features(data)
        data = self.create_user_features(data)
        data = self.create_item_features(data, meta)
        logger.info(
            "engineered %d feature columns", len(data.extra) - before_cols
        )
        return data

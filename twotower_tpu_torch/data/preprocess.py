"""Columnar preprocessing pipeline (the PyTorch port's own copy of
``twotower_tpu/data/preprocess.py``: the same arrays, bit for bit).

Behavioral parity with the reference's ``AmazonReviewsPreprocessor``
(src/data/preprocessor.py:347-586) — dedupe, text cleaning + length gate,
rating-range filter, iterative k-core, id encoding, temporal/random splits —
re-implemented over numpy columns. The k-core fixpoint runs on ``np.bincount``
over encoded ids (O(n) per iteration) instead of pandas
``value_counts``/``isin`` (reference hot loop, preprocessor.py:197-211).

The public surface follows the reference's *test-implied* API (SURVEY.md §4):
decomposed filter steps, ``split_data(method=...)``, and ``user_idx``/
``item_idx`` output naming (matching prepare_training_data.py:209-210).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from twotower_tpu_torch.config import PreprocessingConfig
from twotower_tpu_torch.data.base import DataProcessor
from twotower_tpu_torch.data.schema import Interactions
from twotower_tpu_torch.data.text import TextProcessor
from twotower_tpu_torch.data.vocab import Vocabulary, VocabPair
from twotower_tpu_torch.logging_utils import get_logger, log_retention

logger = get_logger(__name__)


@dataclass
class Splits:
    train: Interactions
    val: Interactions
    test: Interactions

    def __iter__(self):
        return iter((self.train, self.val, self.test))


class InteractionFilter:
    """Rating-range + iterative k-core filtering
    (reference: src/data/preprocessor.py:152-218)."""

    def __init__(self, config: PreprocessingConfig):
        self.config = config

    def filter_by_rating(self, data: Interactions) -> Interactions:
        f = self.config.filtering
        mask = (data.rating >= f.min_rating) & (data.rating <= f.max_rating)
        return data.select(mask)

    def filter_by_frequency(self, data: Interactions) -> Interactions:
        """Iterative alternating user/item min-count filtering until fixpoint
        or max iterations (reference: preprocessor.py:192-211).

        Uses factorized ids + bincount: each iteration is O(n)."""
        min_u = self.config.min_interactions_per_user
        min_i = self.config.min_interactions_per_item
        max_iters = self.config.max_kcore_iterations

        # Factorize once; filter on the integer codes.
        _, u_codes = np.unique(data.user_id.astype(str), return_inverse=True)
        _, i_codes = np.unique(data.item_id.astype(str), return_inverse=True)
        keep = np.ones(len(data), dtype=bool)

        for iteration in range(max_iters):
            u_counts = np.bincount(u_codes[keep], minlength=u_codes.max() + 1 if len(u_codes) else 1)
            i_counts = np.bincount(i_codes[keep], minlength=i_codes.max() + 1 if len(i_codes) else 1)
            new_keep = keep & (u_counts[u_codes] >= min_u) & (i_counts[i_codes] >= min_i)
            if new_keep.sum() == keep.sum():
                logger.debug("k-core converged after %d iterations", iteration + 1)
                break
            keep = new_keep
            if not keep.any():
                break
        return data.select(keep)

    def filter(self, data: Interactions) -> Interactions:
        before = len(data)
        data = self.filter_by_rating(data)
        data = self.filter_by_frequency(data)
        log_retention(logger, "interaction_filter", before, len(data))
        return data

    # Reference-compatible alias (preprocessor.py:175).
    filter_interactions = filter


class Preprocessor(DataProcessor):
    """End-to-end preprocessing orchestrator
    (reference: src/data/preprocessor.py:386-508)."""

    def __init__(self, config: PreprocessingConfig | None = None):
        self.config = config or PreprocessingConfig()
        self.text_processor = TextProcessor(self.config)
        self.interaction_filter = InteractionFilter(self.config)
        self.vocab: VocabPair | None = None

    # ------------------------------------------------------------------
    # Pipeline steps (decomposed, test-implied API)
    # ------------------------------------------------------------------

    def basic_cleaning(self, data: Interactions) -> Interactions:
        """Dedupe on (user, item) keeping the latest interaction
        (reference: preprocessor.py:431-445; 'remove_duplicates' flag
        configs/data_config.yaml:49)."""
        before = len(data)
        if self.config.filtering.remove_duplicates and len(data):
            pair_keys = np.char.add(
                np.char.add(data.user_id.astype(str), "\x00"),
                data.item_id.astype(str),
            )
            # Keep the most recent interaction per (user,item): stable sort by
            # timestamp then unique-keep-last via reversed first-occurrence.
            order = np.argsort(data.timestamp, kind="stable")
            rev = order[::-1]
            _, first_idx = np.unique(pair_keys[rev], return_index=True)
            keep_rows = np.sort(rev[first_idx])
            data = data.select(keep_rows)
        log_retention(logger, "basic_cleaning", before, len(data))
        return data

    def process_text(self, data: Interactions) -> Interactions:
        """Clean text and apply length gate (reference: preprocessor.py:447-462).
        When no text column exists this is a no-op (5-core parity path)."""
        if data.text is None:
            return data
        before = len(data)
        cleaned = self.text_processor.clean_array(data.text)
        data = data.with_columns(text=cleaned)
        mask = self.text_processor.length_mask(cleaned)
        data = data.select(mask)
        log_retention(logger, "text_filter", before, len(data))
        return data

    def encode_ids(self, data: Interactions) -> Interactions:
        """Build vocabularies and attach contiguous ``user_idx``/``item_idx``
        (reference: preprocessor.py:478-491 + prepare_training_data.py:113-123)."""
        users = Vocabulary.build(data.user_id)
        items = Vocabulary.build(data.item_id)
        self.vocab = VocabPair(users=users, items=items)
        return data.with_columns(
            user_idx=users.encode(data.user_id),
            item_idx=items.encode(data.item_id),
        )

    # ------------------------------------------------------------------

    def process(self, data: Interactions) -> Interactions:
        """Full pipeline: clean -> text -> k-core -> encode
        (reference 5-step pipeline, preprocessor.py:386-491; feature
        engineering is the optional separate features module)."""
        if len(data) == 0:
            raise ValueError("cannot preprocess an empty interaction set")
        data = self.basic_cleaning(data)
        data = self.process_text(data)
        data = self.interaction_filter.filter(data)
        if len(data) == 0:
            raise ValueError("all interactions filtered out; relax k-core thresholds")
        data = self.encode_ids(data)
        self._log_statistics(data)
        return data

    def _log_statistics(self, data: Interactions) -> None:
        """Dataset stats incl. sparsity (reference: preprocessor.py:493-508)."""
        logger.info(
            "processed: %d interactions, %d users, %d items, sparsity %.6f",
            len(data),
            data.num_users,
            data.num_items,
            data.sparsity,
        )

    # ------------------------------------------------------------------
    # Splits
    # ------------------------------------------------------------------

    def split_data(self, data: Interactions, method: str = "temporal", seed: int = 42) -> Splits:
        """Unified split entry point (test-implied API, SURVEY.md §4)."""
        if method == "temporal":
            return self.split_temporal(data)
        if method == "random":
            return self.split_random(data, seed=seed)
        raise ValueError(f"unknown split method {method!r}")

    def split_temporal(self, data: Interactions) -> Splits:
        """Sort by timestamp, slice train/val/test fractions
        (reference: preprocessor.py:510-543)."""
        order = np.argsort(data.timestamp, kind="stable")
        n = len(order)
        n_train = int(n * self.config.train_split)
        n_val = int(n * self.config.val_split)
        return Splits(
            train=data.select(order[:n_train]),
            val=data.select(order[n_train : n_train + n_val]),
            test=data.select(order[n_train + n_val :]),
        )

    def split_random(self, data: Interactions, seed: int = 42) -> Splits:
        """Two-stage random split, stratified by rating when feasible
        (reference: preprocessor.py:545-586)."""
        rng = np.random.default_rng(seed)
        n = len(data)
        ratings = data.rating.astype(np.int64)
        # Stratify when every rating bucket has enough members.
        _, counts = np.unique(ratings, return_counts=True)
        stratify = counts.min() >= 3

        idx = np.arange(n)
        if stratify:
            train_parts: list[np.ndarray] = []
            val_parts: list[np.ndarray] = []
            test_parts: list[np.ndarray] = []
            for r in np.unique(ratings):
                bucket = rng.permutation(idx[ratings == r])
                nb = len(bucket)
                nt = int(round(nb * self.config.train_split))
                nv = int(round(nb * self.config.val_split))
                train_parts.append(bucket[:nt])
                val_parts.append(bucket[nt : nt + nv])
                test_parts.append(bucket[nt + nv :])
            return Splits(
                train=data.select(np.sort(np.concatenate(train_parts))),
                val=data.select(np.sort(np.concatenate(val_parts))),
                test=data.select(np.sort(np.concatenate(test_parts))),
            )
        perm = rng.permutation(n)
        n_train = int(n * self.config.train_split)
        n_val = int(n * self.config.val_split)
        return Splits(
            train=data.select(np.sort(perm[:n_train])),
            val=data.select(np.sort(perm[n_train : n_train + n_val])),
            test=data.select(np.sort(perm[n_train + n_val :])),
        )

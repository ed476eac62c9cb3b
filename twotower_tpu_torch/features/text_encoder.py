"""Hashed n-gram text encoder for item text (the port's own copy).

Counterpart of ``twotower_tpu/features/text_encoder.py``, numpy only, the
same hash bit for bit: deterministic blake2b hashing of unigrams and
bigrams into a fixed bucket space, emitted as a static-shape ``[N,
max_tokens]`` int32 matrix with token 0 for padding. On the device the
model mean-pools a bucket-embedding lookup over these tokens
(``models.two_tower.pool_text``), an embedding-bag the JAX package leaves to
the compiler's gather and reduce, and the port to torch ops.
"""

from __future__ import annotations

import hashlib

import numpy as np

PAD_ID = 0  # token id 0 is reserved for padding; buckets are [1, num_buckets)


def _truthy_col(col: np.ndarray | None, n: int) -> np.ndarray:
    if col is None:
        return np.zeros(n, bool)
    # Exact Python truthiness in one C-dispatched pass (object-array
    # np.not_equal is also a per-element Python loop, so this costs the
    # same and cannot diverge from a per-row `if col[row]:` — e.g. a falsy
    # non-string like 0 or False must NOT claim an item's slot).
    return np.frompyfunc(bool, 1, 1)(col).astype(bool)


def select_first_item_texts(
    item_idx: np.ndarray,
    texts: np.ndarray | None,
    num_items: int,
    titles: np.ndarray | None = None,
) -> tuple[np.ndarray, list[str]]:
    """First non-empty text occurrence per item: ``(items, combined_texts)``.

    The shared item-text selection both encoders (hashed n-gram and
    transformer) build their per-item token tables from: for each item id in
    ``[0, num_items)``, the first interaction row with any text, combined as
    ``"{title} {text}"`` (title preferred, text appended). Vectorized — the
    Python-level work is one string join per ITEM, never per interaction row.
    """
    n = len(item_idx)
    item_idx = np.asarray(item_idx)
    has_any = _truthy_col(titles, n) | _truthy_col(texts, n)
    cand = np.flatnonzero(has_any & (item_idx >= 0) & (item_idx < num_items))
    # np.unique(return_index) is stable: first qualifying row per item.
    uniq_items, first = np.unique(item_idx[cand], return_index=True)
    out_texts: list[str] = []
    for row in cand[first].tolist():
        text = None
        if titles is not None and titles[row]:
            text = str(titles[row])
        if texts is not None and texts[row]:
            text = (text + " " if text else "") + str(texts[row])
        out_texts.append(text or "")
    return uniq_items, out_texts


class HashedNgramEncoder:
    """Deterministic text -> fixed-shape hashed token ids."""

    _CACHE_CAP = 1 << 22  # ~4M distinct ngrams; beyond that stop growing

    def __init__(
        self,
        num_buckets: int = 1 << 16,
        max_tokens: int = 32,
        ngrams: tuple[int, ...] = (1, 2),
        seed: int = 42,
    ):
        if num_buckets < 2:
            raise ValueError("num_buckets must be >= 2")
        self.num_buckets = num_buckets
        self.max_tokens = max_tokens
        self.ngrams = ngrams
        self.seed = seed
        # Token -> bucket memo: natural-language ngram frequencies are
        # Zipfian, so the blake2b cost concentrates on a small distinct set.
        self._cache: dict[str, int] = {}

    def _hash(self, token: str) -> int:
        h = self._cache.get(token)
        if h is not None:
            return h
        digest = hashlib.blake2b(
            token.encode("utf-8"), digest_size=8, key=str(self.seed).encode()
        ).digest()
        # [1, num_buckets): keep 0 free for padding.
        h = int.from_bytes(digest, "little") % (self.num_buckets - 1) + 1
        if len(self._cache) < self._CACHE_CAP:
            self._cache[token] = h
        return h

    def encode_one(self, text: str | None) -> np.ndarray:
        out = np.full(self.max_tokens, PAD_ID, np.int32)
        if not text:
            return out
        words = str(text).lower().split()
        pos = 0
        for n in self.ngrams:
            for i in range(len(words) - n + 1):
                if pos >= self.max_tokens:
                    return out
                out[pos] = self._hash(" ".join(words[i : i + n]))
                pos += 1
        return out

    def encode(self, texts: np.ndarray) -> np.ndarray:
        """``[N]`` object array -> ``[N, max_tokens]`` int32.

        Deduplicates whole texts first (titles and short reviews repeat
        heavily), encodes each distinct text once, and scatters back —
        measured >10x the naive per-row pass on duplicate-heavy columns.
        """
        norm = np.array(
            ["" if t is None else str(t) for t in texts], dtype=object
        )
        uniq, inverse = np.unique(norm, return_inverse=True)
        out_u = np.empty((len(uniq), self.max_tokens), np.int32)
        for i, t in enumerate(uniq):
            out_u[i] = self.encode_one(t)
        return out_u[inverse.reshape(norm.shape)]

    def encode_per_item(
        self,
        item_idx: np.ndarray,
        texts: np.ndarray,
        num_items: int,
        titles: np.ndarray | None = None,
    ) -> np.ndarray:
        """Build the per-item token table ``[num_items, max_tokens]``.

        Each item gets the tokens of its first non-empty text occurrence
        (title preferred when available) — the item-side text feature matrix
        consumed by the candidate tower and the eval corpus encode.

        The first-occurrence selection is vectorized (mask + stable
        ``np.unique``): the Python-level work is one ``encode_one`` per
        ITEM, never per interaction row (the corpus has ~50x more rows than
        items at production scale).
        """
        table = np.full((num_items, self.max_tokens), PAD_ID, np.int32)
        items, item_texts = select_first_item_texts(
            item_idx, texts, num_items, titles
        )
        for item, text in zip(items.tolist(), item_texts):
            table[item] = self.encode_one(text)
        return table

    def encode_per_item_slow(
        self,
        item_idx: np.ndarray,
        texts: np.ndarray,
        num_items: int,
        titles: np.ndarray | None = None,
    ) -> np.ndarray:
        """Per-interaction-row reference loop — the semantics twin
        ``encode_per_item`` is equality-tested against."""
        table = np.full((num_items, self.max_tokens), PAD_ID, np.int32)
        filled = np.zeros(num_items, bool)
        for row in range(len(item_idx)):
            item = int(item_idx[row])
            if item < 0 or item >= num_items or filled[item]:
                continue
            text = None
            if titles is not None and titles[row]:
                text = str(titles[row])
            if texts is not None and texts[row]:
                text = (text + " " if text else "") + str(texts[row])
            if text:
                table[item] = self.encode_one(text)
                filled[item] = True
        return table

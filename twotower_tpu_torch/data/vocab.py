"""Vocabulary: deterministic contiguous id spaces + sharding manifest (the
PyTorch port's own copy of ``twotower_tpu/data/vocab.py``; the saved
format is the same, so either package reads the other's vocab).

Parity: the reference builds sorted-unique -> contiguous int maps and pickles
them (prepare_training_data.py:113-123, :229-234). Here the vocab is the
embedding-table *sharding manifest*: it also records item frequencies (needed
globally for log-Q correction under in-batch sampling, see ops/losses.py) and
row-shard boundaries for a model-parallel mesh axis. Persistence is
npz + JSON (no pickle; the reference had to `# nosec` its pickle usage).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class Vocabulary:
    """Bidirectional id <-> index mapping for one entity (users or items)."""

    ids: np.ndarray  # sorted unique raw ids (object), index = encoded idx
    counts: np.ndarray  # int64 occurrence counts aligned with ids

    def __post_init__(self) -> None:
        self._index: dict | None = None
        self._ids_str: np.ndarray | None = None

    @classmethod
    def build(cls, raw_ids: np.ndarray) -> "Vocabulary":
        """Sorted uniques -> contiguous ints (prepare_training_data.py:113-123
        semantics: deterministic given the same id set)."""
        ids, counts = np.unique(raw_ids.astype(str), return_counts=True)
        return cls(ids=ids.astype(object), counts=counts.astype(np.int64))

    def __len__(self) -> int:
        return len(self.ids)

    @property
    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.ids)}
        return self._index

    def encode(self, raw_ids: np.ndarray, missing: int = -1) -> np.ndarray:
        """Map raw ids -> int32 indices; unseen ids -> ``missing``.

        Vectorized: a searchsorted + equality check replaces a per-row
        Python dict loop (material at tens of millions of rows). ``build``
        produces sorted ids, but the lookup goes through a cached argsort
        permutation so vocabularies constructed in a foreign order (e.g.
        migrated from a reference ``mappings.pkl``, ``data/migrate.py``)
        encode correctly too."""
        raw = np.asarray(raw_ids).astype(str)
        if self._ids_str is None:
            # cache the unicode cast + sort permutation: this sits on the
            # per-request serving path
            s = self.ids.astype(str)
            order = np.argsort(s).astype(np.int64)
            self._ids_str = s[order]
            self._order = order
        ids = self._ids_str
        pos = np.searchsorted(ids, raw)
        pos_c = np.clip(pos, 0, max(len(ids) - 1, 0))
        found = ids[pos_c] == raw if len(ids) else np.zeros(len(raw), bool)
        orig = self._order[pos_c] if len(ids) else pos_c
        return np.where(found, orig, missing).astype(np.int32)

    def decode(self, indices: np.ndarray) -> np.ndarray:
        return self.ids[np.asarray(indices)]

    @property
    def frequencies(self) -> np.ndarray:
        """Empirical sampling probabilities (float64, sums to 1) — the
        global statistics that drive log-Q correction."""
        total = self.counts.sum()
        return self.counts / max(total, 1)

    # ------------------------------------------------------------------
    # Sharding manifest
    # ------------------------------------------------------------------

    def padded_size(self, multiple: int) -> int:
        """Table rows padded up so every model shard is equal-sized and
        lane aligned, with at least one spare row reserved — the SAME
        formula as ``models.two_tower.padded_rows`` (the dead-row scatter
        target), so shard bounds match the real table layout."""
        n = max(len(self), 1)
        return -(-(n + 1) // multiple) * multiple

    def shard_bounds(self, num_shards: int, pad_multiple: int = 128) -> list[tuple[int, int]]:
        """Contiguous row ranges per model shard over the padded table."""
        padded = self.padded_size(num_shards * pad_multiple)
        per = padded // num_shards
        return [(s * per, (s + 1) * per) for s in range(num_shards)]

    # ------------------------------------------------------------------
    # Persistence (npz + JSON manifest; no pickle)
    # ------------------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path.with_suffix(".npz"),
            ids=self.ids.astype(str),
            counts=self.counts,
        )
        manifest = {
            "size": len(self),
            "total_count": int(self.counts.sum()),
            "format": "twotower_tpu.vocab.v1",
        }
        path.with_suffix(".json").write_text(json.dumps(manifest, indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "Vocabulary":
        path = Path(path)
        with np.load(path.with_suffix(".npz"), allow_pickle=False) as data:
            return cls(ids=data["ids"].astype(object), counts=data["counts"])


@dataclass
class VocabPair:
    """User + item vocabularies saved together as the training artifact
    (replaces the reference's mappings.pkl, prepare_training_data.py:229-234)."""

    users: Vocabulary
    items: Vocabulary

    def save(self, directory: str | Path) -> None:
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        self.users.save(directory / "user_vocab")
        self.items.save(directory / "item_vocab")

    @classmethod
    def load(cls, directory: str | Path) -> "VocabPair":
        directory = Path(directory)
        return cls(
            users=Vocabulary.load(directory / "user_vocab"),
            items=Vocabulary.load(directory / "item_vocab"),
        )

"""``serve-model`` for the PyTorch port:
``python -m twotower_tpu_torch.serving.api --checkpoint-dir ...``.

Counterpart of ``twotower_tpu/serving/api.py``: a thin HTTP front over the
``RetrievalIndex``. Request ids are encoded through the checkpoint's vocab,
queries run the query tower and the corpus search in batches, and responses
carry raw item ids and scores.

The handler core is framework-free and needs no package beyond the index:
``RecommendService`` (validation, exclusions, history, hot reload, health),
``MicroBatcher`` (coalesces concurrent searches into shared device calls)
and ``CoalescedRoutes`` (the three POST routes' coalesced handlers). The
aiohttp front (``create_app``) imports aiohttp only when it is built, so the
core imports and runs without it. The FastAPI front is not ported yet
(ROADMAP.md, Queue 1: serving).
"""

from __future__ import annotations

import argparse
import asyncio
import functools
import json
import os
import sys
import threading
import time
from typing import Any

import numpy as np

from twotower_tpu_torch.config import Config, load_config_for_checkpoint, parse_cli_overrides
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

_SHARDED_SERVING = "ROADMAP.md, Queue 1: Sharded serving and the scaling tools"


class ServingError(ValueError):
    """Client error (HTTP 400/404)."""

    def __init__(self, message: str, status: int = 400):
        super().__init__(message)
        self.status = status


class ModelSnapshot:
    """One consistent (index, vocab, default_k) view of the live model.

    Every request takes a snapshot ONCE and uses it for validation AND
    execution, so a hot reload racing the request can never validate
    against one catalog and score against another."""

    __slots__ = ("index", "vocab", "default_k")

    def __init__(self, index, vocab, default_k: int):
        self.index = index
        self.vocab = vocab
        self.default_k = default_k


class RecommendService:
    """Framework-free handler core of the HTTP front."""

    def __init__(
        self, index, vocab, *, default_k: int = 100, max_batch: int = 256,
        index_factory=None, max_exclude: int = 256, max_history: int = 256,
    ):
        self.index = index
        self.vocab = vocab
        self.max_exclude = max_exclude
        self.max_history = max_history
        # Clamp to the catalog: a default wider than the corpus would 400
        # every k-less request on small deployments. Explicit k still
        # validates against the true corpus size.
        self._configured_k = default_k
        self.default_k = max(1, min(default_k, index.num_items))
        self.max_batch = max_batch
        self.started = time.time()
        self._requests = 0
        self._lock = threading.Lock()  # handlers run on executor threads
        # Hot reload: ``index_factory(step=None) -> RetrievalIndex`` rebuilds
        # the index from the (possibly newer) checkpoint; ``reloads`` counts
        # successful swaps (surfaced in /health as the model generation).
        # ``_reload_lock`` serializes concurrent reloads.
        self._index_factory = index_factory
        self._reload_lock = threading.Lock()
        self.reloads = 0

    @property
    def requests(self) -> int:
        return self._requests

    @property
    def configured_k(self) -> int:
        """The configured default k BEFORE catalog clamping (what
        ``default_k`` becomes after a reload to a large-enough catalog)."""
        return self._configured_k

    def _count_request(self) -> None:
        with self._lock:
            self._requests += 1

    def snapshot(self) -> ModelSnapshot:
        """Consistent per-request view of (index, vocab, default_k)."""
        with self._lock:
            if self.index is None:  # release_first reload in progress/failed
                raise ServingError("model is reloading; retry shortly", status=503)
            return ModelSnapshot(self.index, self.vocab, self.default_k)

    def reload(
        self, step: int | None = None, *, release_first: bool = False,
        pre_swap=None,
    ) -> dict[str, Any]:
        """Swap in a freshly built index (hot model update).

        Default (blue-green): builds the new index FIRST (the old one keeps
        serving), then swaps the reference atomically. Requests snapshot the
        model once (``snapshot``), so in-flight requests finish entirely on
        the model they validated against. Both corpora are resident on the
        device during the build: keep twice the corpus's memory free, or
        pass ``release_first=True`` to drop the old index before building
        (requests during the rebuild get 503 "model is reloading"; a failed
        rebuild leaves the server 503ing until a reload succeeds).

        The vocab swaps with the index (a retrained model may have new id
        spaces) and the default k re-clamps to the new catalog size.

        ``pre_swap``: optional callable invoked with the NEW index after the
        build but before the swap: the hook for warming the batchers' shapes
        against the new index while the old one still serves. A raising
        hook aborts the swap.
        """
        if self._index_factory is None:
            raise ServingError("server was started without a reloadable checkpoint", 400)
        if step is not None and not isinstance(step, int):
            raise ServingError(f"invalid step: {step!r}")
        with self._reload_lock:
            if release_first:
                with self._lock:
                    self.index = None  # snapshots now 503; old buffers free
            new_index = self._index_factory(step=step)
            if pre_swap is not None:
                pre_swap(new_index)
            with self._lock:
                self.index = new_index
                self.vocab = getattr(new_index, "vocab", self.vocab)
                self.default_k = max(1, min(self._configured_k, new_index.num_items))
                self.reloads += 1
        logger.info(
            "hot-reloaded serving index: step=%s items=%d (generation %d)",
            getattr(new_index, "checkpoint_step", None),
            new_index.num_items, self.reloads,
        )
        return {
            "status": "reloaded",
            "checkpoint_step": getattr(new_index, "checkpoint_step", None),
            "num_items": new_index.num_items,
            "num_users": new_index.num_users,
            "generation": self.reloads,
        }

    # ------------------------------------------------------------------

    @staticmethod
    def _check_payload(payload: Any) -> dict:
        if not isinstance(payload, dict):
            raise ServingError("payload must be a JSON object")
        return payload

    @staticmethod
    def _get_k(payload: dict, default_k: int) -> int:
        try:
            return int(payload.get("k", default_k))
        except (TypeError, ValueError) as e:
            raise ServingError(f"invalid k: {payload.get('k')!r}") from e

    def health(self) -> dict[str, Any]:
        with self._lock:
            index = self.index
        if index is None:
            return {
                "status": "reloading",
                "uptime_s": round(time.time() - self.started, 1),
                "requests": self.requests,
                "model_generation": self.reloads,
            }
        return {
            "status": "ok",
            "uptime_s": round(time.time() - self.started, 1),
            "requests": self.requests,
            "num_users": index.num_users,
            "num_items": index.num_items,
            "checkpoint_step": getattr(index, "checkpoint_step", None),
            "model_generation": self.reloads,
        }

    def _resolve_users(self, payload: dict, snap: ModelSnapshot) -> np.ndarray:
        if "user_idx" in payload:
            try:
                idx = np.atleast_1d(np.asarray(payload["user_idx"], np.int64))
            except (TypeError, ValueError) as e:
                raise ServingError("user_idx must be integers") from e
        elif "user_id" in payload:
            ids = payload["user_id"]
            ids = [ids] if isinstance(ids, str) else list(ids)
            idx = snap.vocab.users.encode(np.asarray(ids, object))
            unknown = [i for i, v in zip(ids, idx) if v < 0]
            if unknown:
                raise ServingError(f"unknown user ids: {unknown[:5]}", status=404)
            idx = idx.astype(np.int64)
        else:
            raise ServingError("payload must contain user_id or user_idx")
        if len(idx) == 0:
            raise ServingError("user batch must be non-empty")
        if len(idx) > self.max_batch:
            raise ServingError(f"batch too large: {len(idx)} > {self.max_batch}")
        if (idx < 0).any() or (idx >= snap.index.num_users).any():
            raise ServingError("user_idx out of range", status=404)
        return idx.astype(np.int32)

    def _resolve_exclude(self, payload: dict, snap: ModelSnapshot) -> np.ndarray:
        """Items to filter from results: ``exclude_idx`` (indices, strict)
        and/or ``exclude`` (external item ids; unknown ids are a no-op:
        excluding a retired item must not fail the request)."""
        parts = []
        if "exclude_idx" in payload:
            try:
                idx = np.atleast_1d(np.asarray(payload["exclude_idx"], np.int64))
            except (TypeError, ValueError) as e:
                raise ServingError("exclude_idx must be integers") from e
            if len(idx) and ((idx < 0).any() or (idx >= snap.index.num_items).any()):
                raise ServingError("exclude_idx out of range", status=404)
            parts.append(idx)
        if "exclude" in payload:
            ids = payload["exclude"]
            ids = [ids] if isinstance(ids, str) else list(ids)
            if ids:
                enc = snap.vocab.items.encode(np.asarray(ids, object)).astype(np.int64)
                parts.append(enc[enc >= 0])  # unknown ids: no-op
        if not parts:
            return np.empty(0, np.int32)
        excl = np.unique(np.concatenate(parts)).astype(np.int32)
        if len(excl) > self.max_exclude:
            raise ServingError(
                f"exclusion list too large: {len(excl)} > {self.max_exclude} "
                "(serving.max_exclude)"
            )
        return excl

    @staticmethod
    def search_depth(k: int, num_excluded: int, num_items: int) -> int:
        """Search k covering the worst case where every excluded id ranks
        above the k-th survivor: ``k`` without exclusions, else the power of
        two covering ``k + num_excluded`` (clamped to the catalog), so the
        depths a route can reach are few and all warmed up front
        (``warm_depths``)."""
        if num_excluded == 0:
            return k
        need = k + num_excluded
        return min(1 << (need - 1).bit_length(), num_items)

    def warm_depths(self, route: str, k: int, num_items: int) -> tuple[int, ...]:
        """Every search depth ``route`` can hit at default ``k``: the
        no-exclusion path plus the power-of-two ladder up to the route's
        worst-case exclusion count (max_exclude for /recommend, plus
        max_history seen-item exclusions for /recommend_by_history)."""
        cap = self.max_exclude
        if route == "recommend_by_history":
            cap += self.max_history
        depths = {k}
        e = 1
        while e <= cap:
            depths.add(self.search_depth(k, e, num_items))
            e *= 2
        depths.add(self.search_depth(k, cap, num_items))
        return tuple(sorted(depths))

    @staticmethod
    def filter_excluded(scores, items, exclude, k: int):
        """Drop excluded ids per row and truncate to k, on the host.

        ``exclude``: one shared [E] array, or a per-row list of arrays
        (history-seen filtering). Rows may come back shorter than k only
        when k + exclusions exceeded the catalog. Returns row lists."""
        out_s, out_i = [], []
        for r, (row_s, row_i) in enumerate(zip(scores, items)):
            e = exclude[r] if isinstance(exclude, list) else exclude
            if len(e):
                mask = ~np.isin(row_i, e)
                row_s, row_i = row_s[mask], row_i[mask]
            out_s.append(row_s[:k])
            out_i.append(row_i[:k])
        return out_s, out_i

    def prepare_recommend(
        self, payload: dict
    ) -> tuple[np.ndarray, int, np.ndarray, ModelSnapshot]:
        """Validate a /recommend payload -> (user_idx [B], k, exclude [E],
        snapshot). Raises ServingError on client mistakes; counts the
        request. Run the search on the returned snapshot, not on
        ``self.index`` (a reload may swap mid-flight)."""
        self._count_request()
        payload = self._check_payload(payload)
        snap = self.snapshot()
        k = self._get_k(payload, snap.default_k)
        if not 1 <= k <= snap.index.num_items:
            raise ServingError(f"k must be in [1, {snap.index.num_items}]")
        exclude = self._resolve_exclude(payload, snap)
        return self._resolve_users(payload, snap), k, exclude, snap

    @staticmethod
    def format_recommend(
        user_idx: np.ndarray, scores: np.ndarray, items: np.ndarray,
        k: int, latency_ms: float, vocab,
    ) -> dict[str, Any]:
        return {
            "results": [
                {
                    "user_idx": int(u),
                    "items": vocab.items.decode(row_i).tolist(),
                    "item_idx": row_i.tolist(),
                    "scores": [round(float(s), 6) for s in row_s],
                }
                for u, row_i, row_s in zip(user_idx, items, scores)
            ],
            "k": k,
            "latency_ms": round(latency_ms, 3),
        }

    def recommend(self, payload: dict) -> dict[str, Any]:
        """POST /recommend: {user_id|user_idx, k?, exclude?|exclude_idx?}
        -> ranked items, the excluded (seen or blocked) items filtered out.

        Synchronous path (library callers, the un-coalesced front); the
        coalesced front routes through ``MicroBatcher`` instead."""
        user_idx, k, exclude, snap = self.prepare_recommend(payload)
        t0 = time.perf_counter()
        scores, items = snap.index.recommend(
            user_idx, self.search_depth(k, len(exclude), snap.index.num_items)
        )
        scores, items = self.filter_excluded(scores, items, exclude, k)
        latency_ms = (time.perf_counter() - t0) * 1000
        return self.format_recommend(user_idx, scores, items, k, latency_ms, snap.vocab)

    def _resolve_history(
        self, payload: dict, snap: ModelSnapshot
    ) -> list[np.ndarray]:
        """Parse {history_idx|history} into per-row index arrays. A flat
        list is one query row; a list of lists is a batch."""
        def nested(v):
            return isinstance(v, (list, tuple)) and (
                len(v) == 0 or isinstance(v[0], (list, tuple, np.ndarray))
            )

        if "history_idx" in payload:
            raw = payload["history_idx"]
            rows_in = raw if nested(raw) else [raw]
            rows = []
            for row in rows_in:
                try:
                    idx = np.atleast_1d(np.asarray(row, np.int64))
                except (TypeError, ValueError) as e:
                    raise ServingError("history_idx must be integers") from e
                if len(idx) and ((idx < 0).any() or (idx >= snap.index.num_items).any()):
                    raise ServingError("history_idx out of range", status=404)
                rows.append(idx)
        elif "history" in payload:
            raw = payload["history"]
            rows_in = raw if nested(raw) else [raw]
            rows = []
            for row in rows_in:
                ids = [row] if isinstance(row, str) else list(row)
                enc = snap.vocab.items.encode(np.asarray(ids, object)).astype(np.int64)
                rows.append(enc[enc >= 0])  # unknown ids dropped from the pool
        else:
            raise ServingError("payload must contain history or history_idx")
        if not rows:
            raise ServingError("history batch must be non-empty")
        if len(rows) > self.max_batch:
            raise ServingError(f"batch too large: {len(rows)} > {self.max_batch}")
        for row in rows:
            if len(row) == 0:
                raise ServingError(
                    "each history row needs at least one known item", status=404
                )
            if len(row) > self.max_history:
                raise ServingError(
                    f"history too long: {len(row)} > {self.max_history} "
                    "(serving.max_history)"
                )
        return rows

    def prepare_history(
        self, payload: dict
    ) -> tuple[np.ndarray, list, int, int, ModelSnapshot]:
        """Validation half of /recommend_by_history: returns
        ``(hist [N,W] padded -1, per_row_exclude, k, search_depth, snap)``
        so the coalesced front can share the device call."""
        self._count_request()
        payload = self._check_payload(payload)
        snap = self.snapshot()
        k = self._get_k(payload, snap.default_k)
        if not 1 <= k <= snap.index.num_items:
            raise ServingError(f"k must be in [1, {snap.index.num_items}]")
        rows = self._resolve_history(payload, snap)
        exclude = self._resolve_exclude(payload, snap)
        exclude_seen = bool(payload.get("exclude_seen", True))
        width = max(len(r) for r in rows)
        hist = np.full((len(rows), width), -1, np.int64)
        for r, row in enumerate(rows):
            hist[r, : len(row)] = row
        per_row = [
            np.union1d(exclude, row) if exclude_seen else exclude for row in rows
        ]
        depth = self.search_depth(
            k, max(len(e) for e in per_row), snap.index.num_items
        ) if any(len(e) for e in per_row) else k
        return hist, per_row, k, depth, snap

    def format_history(
        self, scores, items, per_row, k: int, latency_ms: float, vocab
    ) -> dict[str, Any]:
        """Response half of /recommend_by_history (post-search filter +
        encode)."""
        scores, items = self.filter_excluded(scores, items, per_row, k)
        return {
            "results": [
                {
                    "items": vocab.items.decode(np.asarray(row_i)).tolist(),
                    "item_idx": np.asarray(row_i).tolist(),
                    "scores": [round(float(s), 6) for s in row_s],
                }
                for row_i, row_s in zip(items, scores)
            ],
            "k": k,
            "latency_ms": round(latency_ms, 3),
        }

    def recommend_by_history(self, payload: dict) -> dict[str, Any]:
        """POST /recommend_by_history: {history|history_idx, k?,
        exclude?|exclude_idx?, exclude_seen?=true} -> ranked items.

        Cold-start retrieval for users unseen at training time: each row's
        query is the re-normalized mean of its history items' corpus
        embeddings (``RetrievalIndex.recommend_by_history``). By default the
        history items themselves are filtered from the results."""
        hist, per_row, k, depth, snap = self.prepare_history(payload)
        t0 = time.perf_counter()
        scores, items = snap.index.recommend_by_history(hist, depth)
        latency_ms = (time.perf_counter() - t0) * 1000
        return self.format_history(scores, items, per_row, k, latency_ms, snap.vocab)

    def prepare_similar(
        self, payload: dict
    ) -> tuple[np.ndarray, int, ModelSnapshot]:
        """Validation half of /similar_items: ``(item_idx, k, snap)``."""
        self._count_request()
        payload = self._check_payload(payload)
        snap = self.snapshot()
        k = self._get_k(payload, snap.default_k)
        # k+1 is searched (self-match removed), so k caps at num_items - 1.
        # The k-less default gets the same small-catalog clamp /recommend
        # gets (one item tighter); an explicit k still validates strictly.
        limit = snap.index.num_items - 1
        if "k" not in payload:
            k = max(1, min(k, limit))
        if not 1 <= k <= limit:
            raise ServingError(f"k must be in [1, {limit}]")
        if "item_idx" in payload:
            try:
                idx = np.atleast_1d(np.asarray(payload["item_idx"], np.int64))
            except (TypeError, ValueError) as e:
                raise ServingError("item_idx must be integers") from e
        elif "item_id" in payload:
            ids = payload["item_id"]
            ids = [ids] if isinstance(ids, str) else list(ids)
            idx = snap.vocab.items.encode(np.asarray(ids, object)).astype(np.int64)
            if (idx < 0).any():
                raise ServingError("unknown item ids", status=404)
        else:
            raise ServingError("payload must contain item_id or item_idx")
        if len(idx) == 0:
            raise ServingError("item batch must be non-empty")
        if (idx < 0).any() or (idx >= snap.index.num_items).any():
            raise ServingError("item_idx out of range", status=404)
        if len(idx) > self.max_batch:
            raise ServingError(f"batch too large: {len(idx)} > {self.max_batch}")
        return idx, k, snap

    @staticmethod
    def format_similar(idx, scores, items, k: int, vocab) -> dict[str, Any]:
        """Response half of /similar_items."""
        return {
            "results": [
                {
                    "item_idx": int(i),
                    "items": vocab.items.decode(row_i).tolist(),
                    "scores": [round(float(s), 6) for s in row_s],
                }
                for i, row_i, row_s in zip(idx, items, scores)
            ],
            "k": k,
        }

    def similar_items(self, payload: dict) -> dict[str, Any]:
        """POST /similar_items: {item_id|item_idx, k?} -> neighbours."""
        idx, k, snap = self.prepare_similar(payload)
        scores, items = snap.index.similar_items(idx.astype(np.int32), k)
        return self.format_similar(idx, scores, items, k, snap.vocab)


class MicroBatcher:
    """Coalesces concurrent search traffic into shared device calls.

    A 1-row and a 256-row query cost nearly the same (the corpus stream
    dominates, ``ops/topk.py``). Handlers enqueue ``(queries, k)`` and await
    a future; a single worker task drains the queue for up to ``window_ms``
    (or until ``max_batch`` rows), issues ONE ``index.<method>`` over the
    concatenated query rows in an executor thread (the event loop stays free
    to accept requests), and scatters sliced results back to each waiter.

    Groups are padded up to power-of-two buckets clamped to ``max_batch``.
    PyTorch compiles nothing per shape, but the buckets keep the set of
    shapes live traffic can reach small, so ``warmup`` covers all of them
    (the allocator's blocks and the library's GEMM choices are primed
    before the first request).

    One batcher serves one endpoint family: ``method`` names the index entry
    point (``recommend``, ``similar_items`` or ``recommend_by_history``).
    ``pad_value``/``pad_width`` control the filler rows: user/item ids pad
    with a valid id 0; history rows pad with all ``-1`` (masked empty
    history) at the fixed ``pad_width``.

    The window is ADAPTIVE: it only applies when other requests are already
    queued. A lone request dispatches immediately; under load, requests
    arriving during the in-flight device call accumulate and the next group
    coalesces them.
    """

    def __init__(
        self, index, *, max_batch: int = 256, window_ms: float = 2.0,
        method: str = "recommend", pad_value: int = 0,
        pad_width: int | None = None, query_dtype=np.int32,
    ):
        self.index = index
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.method = method
        self.pad_value = pad_value
        self.pad_width = pad_width  # fixed trailing dim for 2-D queries
        self.query_dtype = query_dtype
        self.batches = 0  # device calls issued (observability)
        self._queue: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None

    async def submit(self, queries: np.ndarray, k: int, index=None):
        """Coalesced equivalent of ``index.<method>(queries, k)``.

        ``index``: the model snapshot the request was VALIDATED against
        (defaults to the batcher's current index). Requests pinned to
        different index objects are never coalesced into one device call,
        so a hot reload mid-window cannot score a request on a model it did
        not validate against."""
        if self.pad_width is not None:
            q = np.full(
                (len(queries), self.pad_width), self.pad_value, self.query_dtype
            )
            q[:, : queries.shape[1]] = queries
            queries = q
        loop = asyncio.get_running_loop()
        if self._worker is None or self._worker.done():
            self._queue = asyncio.Queue()
            self._worker = loop.create_task(self._run(self._queue))
        fut: asyncio.Future = loop.create_future()
        self._queue.put_nowait((queries, k, fut, index or self.index))
        return await fut

    async def recommend(self, user_idx: np.ndarray, k: int, index=None):
        """The /recommend family's :meth:`submit`."""
        return await self.submit(user_idx, k, index)

    def _bucket(self, n: int) -> int:
        # Clamped to max_batch: a non-power-of-two max_batch (say 100) must
        # not round a 65-100-row group up to an unwarmed 128 bucket.
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _device_call(self, queries: np.ndarray, k: int, index=None):
        n = len(queries)
        if n > self.max_batch:  # HTTP fronts validate earlier; direct callers
            raise ServingError(f"batch too large: {n} > {self.max_batch}")
        padded = self._bucket(n)
        if padded != n:  # pad with valid filler rows; sliced off below
            filler = np.full(
                (padded - n,) + queries.shape[1:], self.pad_value, queries.dtype
            )
            queries = np.concatenate([queries, filler])
        target = index if index is not None else self.index
        scores, items = getattr(target, self.method)(queries, k)
        return scores[:n], items[:n]

    def warmup(self, k: int, index=None, *, extra_ks: tuple = ()) -> int:
        """Run every (bucket, depth) shape live traffic can hit once.

        ``extra_ks`` extends the default-``k`` grid with the
        exclusion-widened search depths (``RecommendService.warm_depths``).
        On hot reload pass the NEW index via ``index=`` from the reload's
        pre-swap hook, so it is warmed while the old index still serves.
        Returns the number of shapes run."""
        target = index if index is not None else self.index
        # Clamp to what the index can answer: default_k may exceed a small
        # catalog. similar_items searches k+1 internally, so one tighter.
        limit = target.num_items - (1 if self.method == "similar_items" else 0)
        ks = sorted({max(1, min(kk, limit)) for kk in (k, *extra_ks)})
        sizes = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch)  # the clamp bucket (non-power-of-two too)
        shape_tail = (self.pad_width,) if self.pad_width is not None else ()
        for b in sizes:
            for kk in ks:
                self._device_call(
                    np.full((b,) + shape_tail, self.pad_value, self.query_dtype), kk, target
                )
        return len(sizes) * len(ks)

    async def _run(self, queue: asyncio.Queue):
        # ``queue`` is this worker's own (submit() may install a fresh one
        # for a replacement worker; the shutdown drain must not touch it).
        loop = asyncio.get_running_loop()
        carry = None  # request that would overflow the current group
        group: list = []  # current group (function scope: drained on exit)
        try:
            while True:
                first = carry if carry is not None else await queue.get()
                carry = None
                group = [first]
                total = len(first[0])
                group_index = first[3]
                # Adaptive window: a lone request (empty queue) dispatches
                # immediately; under load, arrivals during the device call
                # queue up and the next group coalesces them.
                deadline = (
                    loop.time() + self.window_s if not queue.empty() else loop.time()
                )
                while total < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(queue.get(), timeout)
                    except asyncio.TimeoutError:
                        break
                    if total + len(nxt[0]) > self.max_batch or nxt[3] is not group_index:
                        # Would exceed max_batch (an unwarmed bucket) OR was
                        # validated against another model snapshot (hot
                        # reload mid-window): it starts the next group.
                        carry = nxt
                        break
                    group.append(nxt)
                    total += len(nxt[0])
                try:
                    queries = np.concatenate([g[0] for g in group])
                    kmax = max(g[1] for g in group)
                    scores, items = await loop.run_in_executor(
                        None, self._device_call, queries, kmax, group_index
                    )
                    self.batches += 1
                    off = 0
                    for q, k, fut, _ in group:
                        n = len(q)
                        if not fut.done():
                            fut.set_result(
                                (scores[off : off + n, :k], items[off : off + n, :k])
                            )
                        off += n
                except Exception as e:  # propagate to every waiter, keep serving
                    for _, _, fut, _ in group:
                        if not fut.done():
                            fut.set_exception(e)
        finally:
            # Worker exiting (cancellation at app teardown, or a bug): fail
            # the in-flight group and every still-queued waiter so no request
            # hangs forever. Completed futures are skipped.
            leftovers = list(group) + ([carry] if carry is not None else [])
            while not queue.empty():
                leftovers.append(queue.get_nowait())
            for _, _, fut, _ in leftovers:
                if not fut.done():
                    fut.set_exception(RuntimeError("serving batcher stopped"))


class CoalescedRoutes:
    """The three POST routes' coalesced handlers, without HTTP: one
    ``MicroBatcher`` per endpoint family over the service's index. The
    aiohttp front wraps these; a caller without aiohttp drives them
    directly under asyncio."""

    def __init__(self, service: RecommendService, *, window_ms: float = 2.0):
        self.service = service
        # Fixed history width bucket: the whole family shares one query
        # shape (pooling over padded -1 columns is masked).
        hist_width = max(1, 1 << (int(service.max_history) - 1).bit_length())
        mb = service.max_batch
        self.batchers: dict[str, MicroBatcher] = {
            "recommend": MicroBatcher(service.index, max_batch=mb, window_ms=window_ms),
            "similar_items": MicroBatcher(
                service.index, max_batch=mb, window_ms=window_ms, method="similar_items",
            ),
            "recommend_by_history": MicroBatcher(
                service.index, max_batch=mb, window_ms=window_ms,
                method="recommend_by_history", pad_value=-1, pad_width=hist_width,
                query_dtype=np.int64,
            ),
        }

    def pin(self, index) -> None:
        """Point every batcher at ``index`` (None drops the pins, so a
        release-first reload frees the old corpus)."""
        for b in self.batchers.values():
            b.index = index

    def warmup(self, k: int, index=None) -> int:
        """Every family's (bucket x depth) shapes at default ``k``, against
        ``index`` (default: the batchers' own)."""
        n_items = (index if index is not None else self.service.index).num_items
        return sum(
            b.warmup(k, index=index, extra_ks=self.service.warm_depths(name, k, n_items))
            for name, b in self.batchers.items()
        )

    async def recommend(self, payload) -> dict[str, Any]:
        service = self.service
        user_idx, k, exclude, snap = service.prepare_recommend(payload)
        t0 = time.perf_counter()
        # Pinned to the snapshot's index: a reload finishing mid-window must
        # not score this request on a model it did not validate against.
        scores, items = await self.batchers["recommend"].submit(
            user_idx, service.search_depth(k, len(exclude), snap.index.num_items),
            index=snap.index,
        )
        scores, items = service.filter_excluded(scores, items, exclude, k)
        latency_ms = (time.perf_counter() - t0) * 1000
        return service.format_recommend(user_idx, scores, items, k, latency_ms, snap.vocab)

    async def similar_items(self, payload) -> dict[str, Any]:
        idx, k, snap = self.service.prepare_similar(payload)
        scores, items = await self.batchers["similar_items"].submit(
            idx.astype(np.int32), k, index=snap.index
        )
        return self.service.format_similar(idx, scores, items, k, snap.vocab)

    async def recommend_by_history(self, payload) -> dict[str, Any]:
        hist, per_row, k, depth, snap = self.service.prepare_history(payload)
        t0 = time.perf_counter()
        scores, items = await self.batchers["recommend_by_history"].submit(
            hist, depth, index=snap.index
        )
        latency_ms = (time.perf_counter() - t0) * 1000
        return self.service.format_history(scores, items, per_row, k, latency_ms, snap.vocab)


# ---------------------------------------------------------------------------
# aiohttp front
# ---------------------------------------------------------------------------

def _admin_authorized(headers, admin_token: str) -> bool:
    """Constant-time check of the admin token against either header form."""
    import hmac

    presented = headers.get("X-Admin-Token", "")
    auth = headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        presented = presented or auth[len("Bearer "):]
    return hmac.compare_digest(presented, admin_token)


@functools.cache
def batcher_key():
    """The app key under which :func:`create_app` exposes its /recommend
    MicroBatcher (None when coalescing is off)."""
    from aiohttp import web

    return web.AppKey("batcher", object)


@functools.cache
def batchers_key():
    """App key for the per-endpoint-family batcher dict
    ({route_name -> MicroBatcher}; empty when coalescing is off)."""
    from aiohttp import web

    return web.AppKey("batchers", object)


def create_app(
    service: RecommendService, *, coalesce: bool = True, window_ms: float = 2.0,
    admin_token: str | None = None,
):
    """Build the aiohttp application.

    ``coalesce`` routes the three POST routes through ``CoalescedRoutes``
    so concurrent requests share device calls. Every handler that touches
    the device runs in an executor thread: the event loop only parses and
    validates, so a burst of searches never stalls /health or new
    connections.

    ``admin_token``: when set, POST /admin/reload requires it (via
    ``Authorization: Bearer <token>`` or ``X-Admin-Token``).
    """
    from aiohttp import web

    routes = CoalescedRoutes(service, window_ms=window_ms) if coalesce else None
    batchers = routes.batchers if routes is not None else {}

    async def health(_request):
        body = service.health()
        if routes is not None:
            body["coalesced_batches"] = sum(b.batches for b in batchers.values())
        # 503 while the model is unloaded (release-first reload in progress
        # or failed): readiness probes must pull the pod from rotation.
        status = 200 if body["status"] == "ok" else 503
        return web.json_response(body, status=status)

    def wrap(handler):
        is_async = asyncio.iscoroutinefunction(handler)

        async def route(request):
            try:
                payload = await request.json()
            except json.JSONDecodeError:
                return web.json_response({"error": "invalid JSON body"}, status=400)
            try:
                if is_async:
                    body = await handler(payload)
                else:
                    # Un-coalesced handlers run the device search off the
                    # event loop, as the batchers do.
                    body = await asyncio.get_running_loop().run_in_executor(
                        None, handler, payload
                    )
                return web.json_response(body)
            except ServingError as e:
                return web.json_response({"error": str(e)}, status=e.status)
            except (TypeError, ValueError, KeyError) as e:
                return web.json_response({"error": f"bad request: {e}"}, status=400)
            except Exception:  # noqa: BLE001 — JSON 500 contract + log
                logger.exception("unhandled serving error")
                return web.json_response({"error": "internal error"}, status=500)

        return route

    reload_lock = asyncio.Lock()

    async def admin_reload(request):
        """POST /admin/reload: hot-swap the model from its checkpoint dir.

        Body (optional): {"step": N} pins a checkpoint step,
        {"release_first": true} drops the old index first. The rebuild runs
        in an executor (the old index keeps serving) and reloads are
        serialized; the batchers' shapes are warmed against the NEW index
        before the swap (pre_swap hook)."""
        if admin_token is not None and not _admin_authorized(request.headers, admin_token):
            return web.json_response({"error": "unauthorized"}, status=401)
        try:
            payload = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            return web.json_response({"error": "invalid JSON body"}, status=400)
        step = payload.get("step") if isinstance(payload, dict) else None
        release_first = bool(
            payload.get("release_first", False) if isinstance(payload, dict) else False
        )
        loop = asyncio.get_running_loop()
        pre_swap = None
        if routes is not None:
            def pre_swap(new_index):
                # configured_k, not the old catalog-clamped default_k: that
                # is what default_k becomes after the swap.
                routes.warmup(service.configured_k, index=new_index)
        async with reload_lock:
            if release_first and routes is not None:
                # Drop the batchers' pins too, or the old corpus stays
                # referenced through the whole rebuild.
                routes.pin(None)
            try:
                info = await loop.run_in_executor(
                    None,
                    functools.partial(
                        service.reload, step, release_first=release_first, pre_swap=pre_swap,
                    ),
                )
            except ServingError as e:
                return web.json_response({"error": str(e)}, status=e.status)
            except FileNotFoundError as e:
                return web.json_response({"error": str(e)}, status=404)
            except Exception as e:  # keep the JSON error contract on 500s
                logger.exception("hot reload failed")
                return web.json_response({"error": f"reload failed: {e}"}, status=500)
            if routes is not None:
                routes.pin(service.index)  # shapes already warmed pre-swap
        return web.json_response(info)

    async def livez(_request):
        # Liveness: process alive, ALWAYS 200 (/health 503s for the whole of
        # a release-first reload; a liveness probe there would kill the pod
        # mid-rebuild).
        return web.json_response({"status": "alive"})

    app = web.Application()
    app[batcher_key()] = batchers.get("recommend")  # for tests/observability
    app[batchers_key()] = batchers
    app.router.add_get("/health", health)
    app.router.add_get("/livez", livez)
    for name in ("recommend", "similar_items", "recommend_by_history"):
        handler = getattr(routes if routes is not None else service, name)
        app.router.add_post(f"/{name}", wrap(handler))
    app.router.add_post("/admin/reload", admin_reload)

    if routes is not None:

        async def _warm(_app):
            t0 = time.perf_counter()
            shapes = await asyncio.get_running_loop().run_in_executor(
                None, routes.warmup, service.default_k
            )
            logger.info(
                "serving warmup: %d (bucket x depth) shapes in %.1fs "
                "(incl. exclusion-widened search depths)",
                shapes, time.perf_counter() - t0,
            )

        app.on_startup.append(_warm)
    return app


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="serve-model",
        description="Serve two-tower retrieval over HTTP (PyTorch port)",
    )
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to serve on (default cuda; there is no fallback to the CPU)",
    )
    p.add_argument("--checkpoint-dir", type=str, required=True)
    p.add_argument("--host", type=str, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument(
        "--shard-corpus", action="store_true",
        help="row-shard the item corpus over all local devices (not ported yet)",
    )
    p.add_argument(
        "--admin-token", type=str,
        default=os.environ.get("TWOTOWER_ADMIN_TOKEN") or None,
        help="require this token on POST /admin/reload (Authorization: "
        "Bearer or X-Admin-Token header); defaults to $TWOTOWER_ADMIN_TOKEN. "
        "Unset = admin routes open (trusted-network deployments only)",
    )
    return p


def build_service(
    config: Config, checkpoint_dir: str, *, device=None
) -> RecommendService:
    """The service over ``checkpoint_dir``'s best-metric step, reloadable
    from the same directory."""
    from twotower_tpu_torch.serving.index import RetrievalIndex

    def factory(step: int | None = None) -> RetrievalIndex:
        return RetrievalIndex.from_checkpoint(config, checkpoint_dir, step=step, device=device)

    index = factory()
    return RecommendService(
        index,
        index.vocab,
        default_k=config.serving.top_k,
        max_batch=config.serving.max_batch_size,
        index_factory=factory,
        max_exclude=config.serving.max_exclude,
        max_history=config.serving.max_history,
    )


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.utils.platform import resolve_device

    setup_logging()
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.shard_corpus:
        parser.error(f"--shard-corpus is not ported yet ({_SHARDED_SERVING})")
    try:
        from aiohttp import web
    except ImportError:
        parser.error(
            "serve-model's HTTP front needs aiohttp, which is not installed; "
            "RecommendService, MicroBatcher and CoalescedRoutes run without it"
        )
    resolve_device(args.device)  # no GPU: raise before any work
    config = load_config_for_checkpoint(
        args.checkpoint_dir, args.config, parse_cli_overrides(args.override)
    )
    service = build_service(config, args.checkpoint_dir, device=args.device)
    window = config.serving.coalesce_window_ms
    app = create_app(
        service, coalesce=window > 0, window_ms=window, admin_token=args.admin_token,
    )
    if args.admin_token is None:
        logger.warning(
            "admin routes are UNAUTHENTICATED (--admin-token / "
            "$TWOTOWER_ADMIN_TOKEN not set): anything that can reach this "
            "port can trigger model reloads"
        )
    host = args.host or config.serving.host
    port = args.port or config.serving.port
    logger.info("serving on http://%s:%d", host, port)
    web.run_app(app, host=host, port=port, print=None)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fixed-shape batch pipeline and host-to-device prefetch (PyTorch).

The port's copy of ``twotower_tpu/data/pipeline.py``: ``BatchPipeline`` is
unchanged (the same ``default_rng(seed + epoch)`` permutation, so both
packages see the same batches); ``DevicePrefetcher`` is unchanged apart from
its docstring, and ``torch_put`` is the ``put`` the port's Trainer gives it.

Batches are plain dicts of arrays: ``user_idx``, ``item_idx`` (int32) and
``weight`` (float32; 0 marks padding when ``drop_remainder=False``).
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Iterator

import numpy as np

from twotower_tpu_torch.data.schema import Interactions


def span_row_indices(host_spans: list, batch_size: int) -> np.ndarray:
    """Validate ``[lo, hi)`` spans against the batch and flatten them into
    the row-index array a process feeds to
    ``jax.make_array_from_process_local_data``. The single source of truth
    for span semantics — used by BatchPipeline, StreamingTrainPipeline
    (``data/prepared.py``), and the Evaluator's multi-controller batch
    assembly (spans themselves are derived from the sharding by
    ``parallel.sharding.process_row_spans``)."""
    for lo, hi in host_spans:
        if not 0 <= lo < hi <= batch_size:
            raise ValueError(f"span ({lo}, {hi}) outside batch [0, {batch_size})")
    return np.concatenate(
        [np.arange(lo, hi, dtype=np.int64) for lo, hi in host_spans]
    )

Batch = dict[str, Any]


class BatchPipeline:
    """Seeded, epoch-aware batch iterator over encoded interactions.

    ``host_spans=[(lo, hi), ...]`` enables the multi-host input path: every
    process runs the SAME seeded permutation (so the global batch
    composition is identical everywhere) but yields only the rows in its
    spans — the ascending union of its addressable devices' global batch
    slices, computed from the actual batch sharding by
    ``parallel.sharding.process_row_spans`` — so no process ever
    materializes the global batch. The trainer assembles the sharded global
    array with ``jax.make_array_from_process_local_data`` (SURVEY.md §5.8;
    reference README.md:17 declares distributed training).
    ``host_shard=(process_index, process_count)`` is shorthand for the
    contiguous equal split (valid only when data shards never span hosts).
    """

    def __init__(
        self,
        data: Interactions,
        batch_size: int,
        shuffle: bool = True,
        drop_remainder: bool = True,
        seed: int = 42,
        host_shard: tuple[int, int] | None = None,
        host_spans: list[tuple[int, int]] | None = None,
    ):
        if data.user_idx is None or data.item_idx is None:
            raise ValueError("data must be encoded (run Preprocessor.process first)")
        self.user_idx = np.ascontiguousarray(data.user_idx, dtype=np.int32)
        self.item_idx = np.ascontiguousarray(data.item_idx, dtype=np.int32)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_remainder = drop_remainder
        self.seed = seed
        if host_shard is not None and host_spans is not None:
            raise ValueError("pass host_shard or host_spans, not both")
        if host_shard is not None:
            index, count = host_shard
            if not 0 <= index < count:
                raise ValueError(f"host_shard index {index} not in [0, {count})")
            if self.batch_size % count:
                raise ValueError(
                    f"batch_size {batch_size} must divide by process count {count}"
                )
            per = self.batch_size // count
            host_spans = [(index * per, (index + 1) * per)]
        self.host_shard = host_shard
        self._span_rows: np.ndarray | None = None
        if host_spans is not None:
            self._span_rows = span_row_indices(host_spans, self.batch_size)

    def __len__(self) -> int:
        n = len(self.user_idx)
        return n // self.batch_size if self.drop_remainder else -(-n // self.batch_size)

    @property
    def num_examples(self) -> int:
        return len(self.user_idx)

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        """One pass over the data; shuffling is deterministic per (seed, epoch)."""
        n = len(self.user_idx)
        order = (
            np.random.default_rng(self.seed + epoch).permutation(n)
            if self.shuffle
            else np.arange(n)
        )
        bs = self.batch_size
        limit = (n // bs) * bs if self.drop_remainder else n
        rows = self._span_rows
        for start in range(0, limit, bs):
            sel = order[start : start + bs]
            pad = bs - len(sel)
            weight = np.ones(bs, dtype=np.float32)
            if pad:
                # Static shape: pad with repeats of row 0, zero-weighted.
                sel = np.concatenate([sel, np.zeros(pad, dtype=sel.dtype)])
                weight[bs - pad :] = 0.0
            if rows is not None:
                sel, weight = sel[rows], weight[rows]
            yield {
                "user_idx": self.user_idx[sel],
                "item_idx": self.item_idx[sel],
                "weight": weight,
            }

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch(0)


class DevicePrefetcher:
    """Background-thread host->device prefetch (depth-bounded).

    Keeps the next ``depth`` batches already put on the device by the
    provided ``put`` callable (``torch_put``) while the device executes the
    current step.
    """

    _END = object()

    def __init__(self, batches: Iterator[Batch], put: Any, depth: int = 2):
        self._queue: collections.deque = collections.deque()
        self._sem = threading.Semaphore(0)
        self._space = threading.Semaphore(depth)
        self._err: BaseException | None = None

        def worker() -> None:
            try:
                for b in batches:
                    self._space.acquire()
                    self._queue.append(put(b))
                    self._sem.release()
            except BaseException as e:  # propagate to consumer
                self._err = e
            finally:
                self._queue.append(self._END)
                self._sem.release()

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Batch:
        self._sem.acquire()
        item = self._queue.popleft()
        if item is self._END:
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._space.release()
        return item


def torch_put(device):
    """``put`` for ``DevicePrefetcher``: a host batch dict -> tensors on
    ``device``.

    On a CUDA device each array is copied into pinned memory and sent with a
    ``non_blocking`` copy on the stream current where ``torch_put`` is
    called, i.e. the consumer's (the prefetch thread's own current stream
    would be the device's default stream, whatever the consumer uses). The
    prefetch thread enqueues the copy before it hands the batch over, and
    the consumer enqueues the step after taking it, so the one stream orders
    copy before step; no event or ``record_stream`` is needed. The pinned staging buffer
    is released only once the copy has run (PyTorch's pinned-memory
    allocator records the copy's event). On the CPU the arrays are wrapped,
    not copied.
    """
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return lambda b: {k: torch.as_tensor(np.asarray(v)) for k, v in b.items()}
    stream = torch.cuda.current_stream(device)

    def put(b: Batch) -> dict:
        with torch.cuda.stream(stream):
            return {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    device, non_blocking=True
                )
                for k, v in b.items()
            }

    return put

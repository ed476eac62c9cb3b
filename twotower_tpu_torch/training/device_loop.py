"""Device-resident training: the train columns on the device, and on a CUDA
device the whole train step captured once as a CUDA graph and replayed.

Counterpart of ``twotower_tpu/training/device_loop.py``, which runs an epoch
as one compiled program (an on-device permutation, then ``lax.scan`` over
the steps). The port keeps its pieces:

- ``DeviceDataset``: the encoded columns (int32 ids, float32 weights) on the
  device, padded with zero-weight rows to a multiple of the batch.
- ``make_epoch_fn``: an epoch is a permutation of the padded rows drawn on
  the device, then ``num_steps`` steps. Each step selects its rows as
  ``perm.view(num_steps, B)[i]``, with ``i`` a counter on the device,
  gathers the three columns and runs the train step: the sparse step with
  its in-device ``dedup_rows`` (host dedup is a host-loop feature, as in
  the JAX device loop), or the dense step where
  ``training.effective_sparse_updates()`` is false (JAX
  ``device_loop.py:82-88``), with the item text tokens when the model has a
  text tower; its metrics are added into sums on the device, and the host
  reads the epoch's means once. The step count, the learning rate and the
  bias corrections are device tensors too (the steps' ``clock``).
  On a CUDA device one CUDA graph holds the whole step (row selection,
  gather, towers, the fused loss's three kernels, the backward, the
  optimizer, the row updates, the metric sums and the counters): it is captured once,
  after warm-up steps that are the first real steps of the first epoch, and
  replayed once a step. On the CPU the same step runs eagerly.
  The sparse step is also captured a second time, into the first graph's
  memory pool, with timing events at its five phases' boundaries
  (``utils.profiling.StepPhases``: gather, forward, backward, optimizer,
  rows); that graph takes the step's place once every ``PHASE_EVERY``
  replays, never while the profiler traces. ``phase_ms`` reads its last
  replay and ``DeviceTrainer`` writes that into each epoch's record as
  ``step/<phase>_ms``. The dense step and the mesh step mark no phases
  (their epochs record none).
- ``DeviceTrainer``: the epoch-granular host loop (validation, early
  stopping, checkpoints on improvement, preemption), as ``Trainer``'s.

A capture or replay that fails raises: there is no fallback to the eager
step or to the host loop.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import replace
from typing import Any

import numpy as np
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.training.loop import (
    EarlyStopping,
    TrainResult,
    _host_metrics,
    ensure_final_persisted,
    warn_dropped_ids,
)
from twotower_tpu_torch.training.state import (
    TrainState,
    make_optimizer,
    opt_slots,
    tree_leaves,
)
from twotower_tpu_torch.utils import profiling
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)

# Eager steps before the capture: they run on the capture stream, so its
# cuBLAS workspace, the kernels' libraries and scratch sizes and the
# allocator's blocks exist before the graph records the step.
WARMUP_STEPS = 2
# The phases' graph replays once in this many: its six event nodes cost
# about 0.7% of a config-3 replay on an H100, which every replay would pay.
PHASE_EVERY = 64


class DeviceDataset:
    """Encoded interactions resident in device memory, padded to a batch
    multiple with zero-weight rows (fixed shapes for every step)."""

    def __init__(self, user_idx, item_idx, batch_size: int, weight=None, *, device=None):
        n = len(user_idx)
        if n == 0:
            raise ValueError("empty dataset")
        self.num_examples = n
        self.batch_size = batch_size
        self.num_steps = -(-n // batch_size)
        padded = self.num_steps * batch_size
        w = np.ones(n, np.float32) if weight is None else np.asarray(weight, np.float32)
        user_idx = np.asarray(user_idx, np.int32)
        item_idx = np.asarray(item_idx, np.int32)
        pad = padded - n
        if pad:
            user_idx = np.concatenate([user_idx, np.zeros(pad, np.int32)])
            item_idx = np.concatenate([item_idx, np.zeros(pad, np.int32)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        dev = resolve_device(device)
        self.columns = {
            "user_idx": torch.from_numpy(user_idx).to(dev),
            "item_idx": torch.from_numpy(item_idx).to(dev),
            "weight": torch.from_numpy(w).to(dev),
        }

    @classmethod
    def from_interactions(cls, data, batch_size: int, *, device=None) -> "DeviceDataset":
        if data.user_idx is None or data.item_idx is None:
            raise ValueError("data must be encoded (run Preprocessor.process first)")
        return cls(data.user_idx, data.item_idx, batch_size, device=device)


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of an epoch's permutation generator: ``training.seed + 1`` and
    the epoch (the JAX loop folds the epoch into ``PRNGKey(seed + 1)``)."""
    return ((seed + 1) << 32) + epoch


class _EpochProgram:
    """``make_epoch_fn``'s epoch function: ``begin_epoch``, ``num_steps``
    times ``step``, ``end_epoch`` (a caller that times single steps drives
    the three itself). The buffers a replayed step reads and writes
    (permutation, row counter, step clock, metric sums) live here, and the
    captured graph is bound to the tensors of the state, columns, log q and
    item tokens of its capture."""

    def __init__(self, config: Config, optimizer, num_steps: int, *, num_items, device,
                 capture, mesh=None):
        from twotower_tpu_torch.training.loop import make_raw_step

        self.device = mesh.device if mesh is not None else resolve_device(device)
        if capture is None:
            capture = self.device.type == "cuda"
        if capture and self.device.type != "cuda":
            raise ValueError("CUDA graph capture needs a CUDA device")
        if capture and mesh is not None and mesh.backend != "nccl":
            raise ValueError(
                f"a {mesh.backend} mesh's collectives on {self.device} wait on the host "
                "(gloo copies CUDA tensors through host memory), which a CUDA graph cannot "
                "capture: the device loop on CUDA needs the nccl backend"
            )
        self.capture = capture
        self.num_steps = num_steps
        self.batch_size = config.training.batch_size
        self.seed = config.training.seed
        self.mesh = mesh
        self._step = make_raw_step(config, optimizer, num_items=num_items, mesh=mesh)
        dev = self.device
        # Dropout masks: one generator for the run, registered with the graph
        # so every replay draws fresh masks.
        self._gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        self._perm = torch.empty(num_steps * self.batch_size, dtype=torch.long, device=dev)
        self._row = torch.zeros(1, dtype=torch.long, device=dev)
        self._clock = torch.zeros((), dtype=torch.float32, device=dev)
        self._sums: dict[str, torch.Tensor] | None = None
        self._graph = None
        self._record = None
        self._bound: tuple | None = None
        self._warm = 0
        self._args: tuple | None = None
        self._done = 0
        self._stream = torch.cuda.Stream(dev) if capture else None
        # The phases' events, recorded by the graph of a step that marks them.
        self._phases = (profiling.StepPhases(boundaries=getattr(
            self._step, "phase_boundaries", profiling.StepPhases.BOUNDARIES))
                        if capture and getattr(self._step, "marks_phases", False) else None)
        # A step over one packed stream (``step.permutes_streams``): the epoch
        # permutes whole streams of ``batch_size`` slots, never the slots
        # within one.
        self._streams = getattr(self._step, "permutes_streams", False)
        self._timed = None  # (graph, launch record) of the step with the phases' events
        self._replays = 0

    def _body(self, state: TrainState, columns: dict, log_q, item_tokens) -> None:
        """One step, every value it reads and writes on the device."""
        profiling.step_phase("gather")
        sel = self._perm.view(self.num_steps, self.batch_size).index_select(0, self._row)
        sel = sel.view(-1)
        if self.mesh is not None:  # this rank's data shard of the step's rows
            from twotower_tpu_torch.parallel.sharding import data_rows

            sel = data_rows(self.mesh, sel)
        batch = {k: v.index_select(0, sel) for k, v in columns.items()}
        _, metrics = self._step(state, batch, self._gen, log_q, item_tokens, clock=self._clock)
        if self._sums is None:
            self._sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self._sums[k].add_(v)
        self._row.add_(1)
        profiling.step_phase("end")

    def begin_epoch(self, state: TrainState, columns: dict, epoch: int, log_q=None,
                    item_tokens=None, *, perm=None) -> None:
        """Set the epoch's buffers: its permutation (for a sequence tower,
        of whole streams: ``randperm(num_steps)`` from the epoch's seed,
        stream ``i`` being rows ``[i B, (i + 1) B)``), the row counter, the
        step clock (``state.step``) and the metric sums."""
        n = self.num_steps * self.batch_size
        rows = next(iter(columns.values())).shape[0]
        if rows != n:
            raise ValueError(
                f"columns hold {rows} rows, the epoch {n} "
                f"({self.num_steps} steps of {self.batch_size})"
            )
        self._bind(state, columns, log_q, item_tokens)
        self._args = (state, columns, log_q, item_tokens)
        if perm is None:
            gen = torch.Generator(device=self.device).manual_seed(epoch_seed(self.seed, epoch))
            if self._streams:
                order = torch.randperm(self.num_steps, generator=gen, device=self.device)
                slots = torch.arange(self.batch_size, device=self.device)
                torch.add(order[:, None] * self.batch_size, slots[None, :],
                          out=self._perm.view(self.num_steps, self.batch_size))
            else:
                torch.randperm(n, generator=gen, out=self._perm)
        else:
            self._perm.copy_(torch.from_numpy(np.array(perm, dtype=np.int64)))
        self._row.zero_()
        self._clock.fill_(float(state.step))
        if self._sums is not None:
            for s in self._sums.values():
                s.zero_()
        self._done = 0

    def step(self) -> None:
        """The epoch's next step: eager on the CPU (or with ``capture``
        off); on CUDA a warm-up step, the capture, or a replay."""
        if self._done >= self.num_steps:
            raise RuntimeError(f"the epoch's {self.num_steps} steps have all run")
        self._done += 1
        if not self.capture:
            self._body(*self._args)
            return
        if self._graph is None:
            current = torch.cuda.current_stream(self.device)
            if self._warm < WARMUP_STEPS:
                self._stream.wait_stream(current)
                with torch.cuda.stream(self._stream):
                    self._body(*self._args)
                current.wait_stream(self._stream)
                self._warm += 1
                return
            self._graph, self._record = self._capture()
            if self._phases is not None:
                # In the step graph's pool: the two graphs never replay at
                # once, and what either keeps (state, sums, row) lives
                # outside it, so they share one set of intermediates.
                self._timed = self._capture(self._phases, pool=self._graph.pool())
                profiling.register_phases(self._phases)
        graph, record = self._graph, self._record
        if self._times_phases():
            graph, record = self._timed
            self._phases.replays += 1
        self._replays += 1
        graph.replay()
        record.replayed()

    def _capture(self, phases=None, pool=None):
        """The step as a CUDA graph (with ``phases``: recording their
        events; with ``pool``: allocating from that graph pool) and the
        record of the kernels' launches in it."""
        from twotower_tpu_torch.ops import build

        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        if hasattr(self._step, "dropout_gen"):  # a mesh step's own masks
            graph.register_generator_state(self._step.dropout_gen)
        marks = contextlib.nullcontext() if phases is None else phases.capturing()
        with build.record_launches() as record, marks:
            with torch.cuda.graph(graph, pool=pool, stream=self._stream):
                self._body(*self._args)
        return graph, record

    def _times_phases(self) -> bool:
        """Whether this replay is the phases' graph's: the first and every
        ``PHASE_EVERY``-th, except while the profiler traces (its cost a
        kernel would enter every phase)."""
        return (self._timed is not None and self._replays % PHASE_EVERY == 0
                and not profiling.tracing())

    def phase_ms(self) -> dict[str, float]:
        """Each phase's device milliseconds in the phases' graph's last
        replay (waits for it): empty on the CPU, before that graph's first
        replay, and for a step that marks no phases."""
        return {} if self._phases is None else self._phases.times_ms()

    def end_epoch(self):
        """``(new_state, {metric: mean over the epoch's steps})`` once every
        step has run; the metrics stay on the device."""
        if self._done != self.num_steps:
            raise RuntimeError(f"{self._done} of the epoch's {self.num_steps} steps ran")
        state = self._args[0]
        self._args = None
        metrics = {k: v / self.num_steps for k, v in self._sums.items()}
        opt = state.opt_state
        return replace(
            state,
            step=state.step + self.num_steps,
            opt_state=replace(opt, count=opt.count + self.num_steps),
        ), metrics

    def _bind(self, state: TrainState, columns: dict, log_q, item_tokens) -> None:
        """The captured graph reads and writes fixed addresses: refuse other
        tensors than those it was captured with."""
        leaves = [state.params, list(opt_slots(state.opt_state).values()), state.table_state,
                  columns, log_q, item_tokens]
        ptrs = tuple(t.data_ptr() for t in tree_leaves(leaves) if t is not None)
        if self._bound is None:
            self._bound = ptrs
        elif self._graph is not None and ptrs != self._bound:
            raise ValueError(
                "the epoch's CUDA graph is bound to the state, columns, log q and item "
                "tokens of its capture; build a new epoch function for other tensors"
            )

    def __call__(self, state: TrainState, columns: dict, epoch: int, log_q=None,
                 item_tokens=None, *, perm=None):
        self.begin_epoch(state, columns, epoch, log_q, item_tokens, perm=perm)
        for _ in range(self.num_steps):
            self.step()
        return self.end_epoch()


def make_epoch_fn(
    config: Config,
    optimizer,
    num_steps: int,
    *,
    num_items: int | None = None,
    device: str | torch.device | None = None,
    capture: bool | None = None,
    mesh=None,
):
    """Build ``epoch_fn(state, columns, epoch, log_q=None, item_tokens=None,
    *, perm=None)``: the epoch's permutation and ``num_steps`` train steps
    (sparse or dense, as ``training.loop.make_raw_step`` dispatches) on
    ``device`` (``cuda`` unless the caller asks for the CPU), returning
    ``(new_state, {metric: epoch mean as a 0-d device tensor})``. The
    state's tensors are updated in place.

    On a CUDA device the step is captured as a CUDA graph and replayed
    (``capture`` defaults to True there). Two hooks for tests: ``perm`` (the
    padded rows' order, in place of the one drawn from ``epoch_seed``), and
    ``capture=False``, which runs the same step eagerly on a CUDA device.

    With ``mesh`` (JAX ``make_sharded_epoch_fn``) every rank holds the whole
    columns and draws the same permutation; each step takes the rank's data
    shard of its rows and runs the mesh step on the rank's shard of the
    state. On ``nccl`` the step, collectives included, is captured and
    replayed; a ``gloo`` mesh over CUDA tensors cannot be captured (its
    collectives wait on the host) and raises, naming the backend; on the
    CPU the step runs eagerly.
    """
    return _EpochProgram(config, optimizer, num_steps, num_items=num_items, device=device,
                         capture=capture, mesh=mesh)


class DeviceTrainer:
    """Epoch-granular host loop over the device-resident epochs: the same
    contract as ``Trainer`` for validation, early stopping and checkpoints,
    on one device (``cuda`` unless the caller passes ``device="cpu"``), or
    on a ``mesh`` (every rank holds the whole columns; the state is the
    rank's shard)."""

    def __init__(
        self,
        config: Config,
        *,
        log_q: np.ndarray | None = None,
        item_tokens: np.ndarray | None = None,
        num_items: int | None = None,
        evaluate_fn=None,
        writers: list[Any] | None = None,
        checkpoint_manager: Any | None = None,
        shutdown: Any | None = None,
        mesh: Any | None = None,
        text_embedding_init: np.ndarray | None = None,
        device: str | torch.device | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.config = config
        self.optimizer = make_optimizer(config.training)
        self.log_q = (
            None if log_q is None
            else torch.as_tensor(log_q, dtype=torch.float32).to(self.device)
        )
        self.item_tokens = (
            None if item_tokens is None else torch.as_tensor(item_tokens).to(self.device)
        )
        self._text_embedding_init = text_embedding_init
        self.num_items = num_items
        self.evaluate_fn = evaluate_fn
        self.writers = writers or []
        self.checkpoint_manager = checkpoint_manager
        self.shutdown = shutdown
        self._epoch_fns: dict[int, Any] = {}

    def init_state(self, num_users: int, num_items: int) -> TrainState:
        from twotower_tpu_torch.training.state import init_train_state

        return init_train_state(
            self.config, self.optimizer, num_users, num_items, mesh=self.mesh,
            text_embedding_init=self._text_embedding_init, device=self.device,
        )

    def _epoch_fn(self, num_steps: int):
        if num_steps not in self._epoch_fns:
            self._epoch_fns[num_steps] = make_epoch_fn(
                self.config, self.optimizer, num_steps,
                num_items=self.num_items, device=self.device, mesh=self.mesh,
            )
        return self._epoch_fns[num_steps]

    def _write(self, record: dict, step: int) -> None:
        for w in self.writers:
            w.write(record, step=step)

    def fit(self, state: TrainState, dataset: DeviceDataset, *, start_epoch: int = 0) -> TrainResult:
        cfg = self.config.training
        epoch_fn = self._epoch_fn(dataset.num_steps)
        stopper = EarlyStopping(patience=cfg.patience)
        result = TrainResult(state=state)
        t_start = time.perf_counter()
        train_time = 0.0

        for epoch in range(start_epoch, cfg.epochs):
            t_epoch = time.perf_counter()
            state, metrics = epoch_fn(state, dataset.columns, epoch, self.log_q,
                                      self.item_tokens)
            host = _host_metrics(metrics)  # the epoch's one read
            warn_dropped_ids(host, epoch=epoch, step=int(state.step))
            epoch_time = time.perf_counter() - t_epoch
            train_time += epoch_time
            eps = dataset.num_examples / max(epoch_time, 1e-9)
            record = {"epoch": float(epoch), "examples_per_sec": eps, **host}
            record.update({f"step/{k}_ms": v for k, v in epoch_fn.phase_ms().items()})

            if self.evaluate_fn is not None and (epoch + 1) % cfg.validation_freq == 0:
                val = self.evaluate_fn(state.params)
                record.update({f"val/{k}": v for k, v in val.items()})
                metric = val.get(cfg.early_stopping_metric)
                if metric is None:
                    raise KeyError(
                        f"early_stopping_metric {cfg.early_stopping_metric!r} "
                        f"not in validation metrics {sorted(val)}"
                    )
                logger.info(
                    "epoch %d: %.1fs (%.0f ex/s) loss %.4f %s=%.4f",
                    epoch, epoch_time, eps, host.get("loss", np.nan),
                    cfg.early_stopping_metric, metric,
                )
                improved = metric > stopper.best
                should_stop = stopper.update(metric, int(state.step))
                if improved and self.checkpoint_manager is not None:
                    self.checkpoint_manager.save(
                        int(state.step), state,
                        metrics={cfg.early_stopping_metric: metric},
                        extra={"epoch": epoch + 1},
                    )
                result.history.append(record)
                self._write(record, int(state.step))
                if should_stop:
                    logger.info("early stopping at epoch %d", epoch)
                    break
            else:
                logger.info(
                    "epoch %d: %.1fs (%.0f ex/s) loss %.4f",
                    epoch, epoch_time, eps, host.get("loss", np.nan),
                )
                result.history.append(record)
                self._write(record, int(state.step))

            if self.shutdown is not None and self.shutdown.should_stop:
                # flush() then force=True: a plain save() could be busy- or
                # interval-skipped, losing the {epoch, preempted} metadata.
                if self.checkpoint_manager is not None:
                    self.checkpoint_manager.flush()
                    self.checkpoint_manager.save(
                        int(state.step), state,
                        extra={"epoch": epoch + 1, "preempted": True},
                        force=True,
                    )
                logger.warning("graceful shutdown after epoch %d", epoch)
                break

        if self.checkpoint_manager is not None:
            self.checkpoint_manager.flush()
            ensure_final_persisted(
                self.checkpoint_manager, state, stopper,
                epoch=start_epoch + len(result.history),
            )
        total = time.perf_counter() - t_start
        result.state = state
        result.best_metric = stopper.best
        result.best_step = stopper.best_step
        result.finalize_throughput(
            len(result.history) * dataset.num_examples, train_time, total
        )
        return result

"""Train step, segment runner and the epoch loop with early stopping
(PyTorch).

Counterpart of ``twotower_tpu/training/loop.py``, single device: the
sparse step (``training/sparse.py``) or the dense step (``make_step_fn``,
which differentiates the whole parameter tree and applies the optimizer to
it), as ``training.sparse_table_updates`` and the optimizer choose; the
host loop feeds fixed-shape batches through a background prefetcher (host
dedup on its thread), reads each dispatch's metrics one dispatch late,
validates, early-stops, saves on improvement and persists progress on
preemption. With ``mesh=`` the step is the mesh step
(``parallel/spmd.py``) on this rank's shard of the state and of each batch
(the pipeline feeds the rank's rows: ``parallel.sharding.process_row_spans``);
metrics are all-reduced, so every rank takes the same decisions, and
checkpoint saves are collective (``utils/checkpoint.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.training.state import (
    Optimizer,
    TrainState,
    lr_at,
    make_optimizer,
    tree_leaves,
    tree_map,
)
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)

TrainStepFn = Callable[[TrainState, dict, Any], tuple[TrainState, dict]]


def make_loss_fn(config: Config, *, num_items: int | None = None):
    """Build ``loss_fn(params, batch, rng, log_q=None, item_tokens=None, *,
    neg_ids=None) -> (loss, metrics)`` over the whole parameter tree (JAX
    ``loop.py:36-131``): both towers (the item tower with the pooled text
    of ``item_tokens[item_idx]`` when given), then the in-batch loss through
    ``in_batch_softmax_loss_auto`` (the fused kernels on CUDA tensors), or
    the uniform or mixed sampled loss over ``retrieval.num_negatives`` ids
    drawn from ``rng`` (``neg_ids`` hands them in), plus the sparse L2.
    ``rng`` is a ``torch.Generator`` on the device (negatives, then the
    dropout masks, in the sparse step's order)."""
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.dispatch import in_batch_softmax_loss_auto
    from twotower_tpu_torch.ops.losses import (
        l2_penalty,
        mixed_sampled_softmax_loss,
        uniform_sampled_softmax_loss,
    )

    mcfg = config.model
    rcfg = config.retrieval
    mode = rcfg.candidate_sampling
    sample_negs = mode in ("uniform", "mixed")
    if sample_negs and num_items is None:
        raise ValueError(
            f"{mode} candidate sampling needs num_items (pass it to make_train_step / the "
            "Trainer)"
        )

    def loss_fn(params, batch: dict, rng, log_q=None, item_tokens=None, *, neg_ids=None):
        u_ids, i_ids = batch["user_idx"], batch["item_idx"]
        if sample_negs:
            if neg_ids is None:
                neg_ids = torch.randint(0, num_items, (rcfg.num_negatives,), generator=rng,
                                        device=i_ids.device)
            neg_ids = neg_ids.to(device=i_ids.device, dtype=i_ids.dtype)
        user_emb = two_tower.embed_users(params, u_ids, mcfg, train=True, dropout_gen=rng)
        tokens = None if item_tokens is None else item_tokens[i_ids]
        item_emb = two_tower.embed_items(params, i_ids, mcfg, train=True, dropout_gen=rng,
                                         text_tokens=tokens)
        weights = batch.get("weight")
        lq = log_q if rcfg.logq_correction else None
        if sample_negs:
            neg_emb = two_tower.embed_items(
                params, neg_ids, mcfg, train=True, dropout_gen=rng,
                text_tokens=None if item_tokens is None else item_tokens[neg_ids],
            )
        if mode == "uniform":
            loss, metrics = uniform_sampled_softmax_loss(
                user_emb, item_emb, neg_emb, temperature=rcfg.temperature, weights=weights,
                pos_idx=i_ids, neg_idx=neg_ids,
            )
        elif mode == "mixed":
            loss, metrics = mixed_sampled_softmax_loss(
                user_emb, item_emb, i_ids, neg_emb, neg_ids, temperature=rcfg.temperature,
                log_q=lq, num_items=num_items, weights=weights,
            )
        else:
            loss, metrics = in_batch_softmax_loss_auto(
                user_emb, item_emb, i_ids, temperature=rcfg.temperature, log_q=lq,
                weights=weights,
            )
        if mcfg.l2_regularization > 0:
            reg = l2_penalty(
                {"user_tower": params["user_tower"], "item_tower": params["item_tower"]},
                [params["user_embedding"][u_ids], params["item_embedding"][i_ids]],
            )
            loss = loss + mcfg.l2_regularization * reg
        return loss, metrics

    return loss_fn


def make_step_fn(config: Config, optimizer: Optimizer, *, num_items: int | None = None):
    """The dense train step ``step(state, batch, rng, log_q=None,
    item_tokens=None, *, clock=None, neg_ids=None)`` (JAX ``loop.py:146-183``):
    the gradient of ``make_loss_fn``'s loss w.r.t. every parameter, tables
    included, then ``optimizer`` over the whole tree, in place, and
    ``grad_norm`` the global norm of all the gradients. The signature and
    ``clock`` are the sparse step's (``training.sparse.make_sparse_step_fn``):
    with ``clock`` the learning rate and the optimizer's count-dependent
    terms are computed on the device and the step can be captured in a
    CUDA graph."""
    loss_fn = make_loss_fn(config, num_items=num_items)

    def step(state: TrainState, batch: dict, rng: Any, log_q=None, item_tokens=None, *,
             clock: torch.Tensor | None = None, neg_ids: torch.Tensor | None = None):
        diff = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        with torch.enable_grad():
            loss, metrics = loss_fn(diff, batch, rng, log_q, item_tokens, neg_ids=neg_ids)
            grads = torch.autograd.grad(loss, tree_leaves(diff))
        lr = None if clock is None else lr_at(config.training, clock)
        new_opt = optimizer.update_(state.params, list(grads), state.opt_state, clock=clock,
                                    lr=lr)
        if clock is not None:
            clock.add_(1.0)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        return TrainState(step=state.step + 1, params=state.params, opt_state=new_opt), metrics

    return step


def make_raw_step(config: Config, optimizer: Optimizer, *, num_items: int | None = None,
                  mesh: Any = None, state_template: TrainState | None = None):
    """The sequence tower's step (``training.seq_step``) for
    ``model.user_tower == "sequence"``; the sparse step when
    ``training.effective_sparse_updates()``, else the dense one (JAX ``make_train_step``'s dispatch, ``loop.py:186-207``); on a
    ``mesh``, the mesh step (``parallel.spmd.make_sharded_train_step``:
    sparse or dense by ``parallel.use_sparse_mesh_path``), which takes this
    rank's data shard of each batch."""
    if mesh is not None:
        from twotower_tpu_torch.parallel.spmd import make_sharded_train_step

        return make_sharded_train_step(config, optimizer, mesh, state_template,
                                       num_items=num_items)
    if config.model.user_tower == "sequence":
        from twotower_tpu_torch.training.seq_step import make_seq_step_fn

        return make_seq_step_fn(config, optimizer)
    if config.training.effective_sparse_updates():
        from twotower_tpu_torch.training.sparse import make_sparse_step_fn

        return make_sparse_step_fn(config, optimizer, num_items=num_items)
    return make_step_fn(config, optimizer, num_items=num_items)


def make_train_step(
    config: Config,
    optimizer: Optimizer,
    log_q: np.ndarray | torch.Tensor | None = None,
    *,
    item_tokens: np.ndarray | torch.Tensor | None = None,
    num_items: int | None = None,
    device: str | torch.device | None = None,
    mesh: Any = None,
    state_template: TrainState | None = None,
) -> TrainStepFn:
    """Build the train step ``step(state, batch, rng)`` on ``device``
    (``cuda`` unless the caller asks for the CPU; a ``mesh``'s own device
    on a mesh): sparse or dense, or the mesh step, as ``make_raw_step``
    dispatches, with ``log_q`` and ``item_tokens`` bound as tensors on the
    device.

    ``batch`` is a dict of numpy arrays or tensors (``user_idx``,
    ``item_idx``, optional ``weight`` and the ``training.host_dedup`` keys);
    they are moved to the device. ``rng`` is a ``torch.Generator`` on the
    device for the dropout masks and sampled negatives (or None at dropout
    0 in_batch). The step updates ``state``'s tensors in place and returns
    ``(new_state, metrics)``.
    """
    dev = mesh.device if mesh is not None else resolve_device(device)
    raw = make_raw_step(config, optimizer, num_items=num_items, mesh=mesh,
                        state_template=state_template)
    lq = None if log_q is None else torch.as_tensor(log_q, dtype=torch.float32).to(dev)
    tok = None if item_tokens is None else torch.as_tensor(item_tokens).to(dev)

    def step(state: TrainState, batch: dict, rng: Any):
        on_dev = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        return raw(state, on_dev, rng, lq, tok)

    return step


def make_segment_runner(step: TrainStepFn):
    """``runner(state, batches, rng)`` steps through ``batches`` — a batch
    dict whose tensors carry a leading segment axis ``[S, B, ...]`` — and
    returns ``(state, mean metrics)``: the counterpart of the JAX package's
    ``lax.scan`` over a segment (``training.segment_steps``). Metrics are
    means over the segment (a positive per-step ``dropped_ids`` stays
    positive in the mean)."""

    def runner(state: TrainState, batches: dict, rng: Any):
        n = int(next(iter(batches.values())).shape[0])
        stacked: dict[str, list] = {}
        for s in range(n):
            state, m = step(state, {k: v[s] for k, v in batches.items()}, rng)
            for k, v in m.items():
                stacked.setdefault(k, []).append(v)
        return state, {k: torch.stack(v).mean() for k, v in stacked.items()}

    return runner


def pack_segments(batches, segment_steps: int):
    """Group an epoch's batch dicts into stacked ``[S, ...]`` segment dicts
    (host-side, runs on the prefetch thread). The final segment carries the
    epoch remainder (shorter leading axis)."""
    buf: list[dict] = []
    for b in batches:
        buf.append(b)
        if len(buf) == segment_steps:
            yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}
            buf = []
    if buf:
        yield {k: np.stack([x[k] for x in buf]) for k in buf[0]}


def ensure_final_persisted(manager, state, stopper: "EarlyStopping", *, epoch: int) -> None:
    """Async save-starvation backstop: when saves are slower than the
    improvement cadence, every improving-epoch save after the first can be
    busy-skipped, leaving the newest durable checkpoint many epochs behind
    the best validation. After the final flush, if the newest durable step
    predates the best validation step, persist the FINAL state (within the
    early-stopping patience of the best) and flush again."""
    if manager is None:
        return
    latest = manager.latest_step()
    if stopper.best_step and (latest is None or latest < stopper.best_step):
        logger.warning(
            "async checkpoint starvation: newest durable checkpoint (step "
            "%s) predates the best validation (step %d); persisting the "
            "final state (step %d)", latest, stopper.best_step, int(state.step),
        )
        manager.save(
            int(state.step), state,
            metrics={"best_val_at_stop": stopper.best},
            extra={"epoch": epoch, "post_starvation_final": True},
            force=True,
        )
        manager.flush()


def warn_dropped_ids(host: dict, *, epoch: int, step: int) -> None:
    """Surface an all-to-all capacity overflow (``dropped_ids`` > 0, a
    metric of the sharded path) as a WARNING: those rows read zeros and
    their gradients are lost."""
    dropped = host.get("dropped_ids", 0.0)
    if dropped and dropped > 0:
        logger.warning(
            "epoch %d step %d: a2a capacity overflow — %d embedding ids "
            "dropped (read zeros / gradients lost); raise "
            "mesh.a2a_capacity_factor (0 disables capacity limiting)",
            epoch, step, int(dropped),
        )


@dataclass
class EarlyStopping:
    """Patience-based early stopping on a maximized metric."""

    patience: int
    best: float = -np.inf
    best_step: int = 0
    bad_rounds: int = 0

    def update(self, value: float, step: int) -> bool:
        """Record a validation metric; returns True if training should stop."""
        if value > self.best:
            self.best = value
            self.best_step = step
            self.bad_rounds = 0
            return False
        self.bad_rounds += 1
        # Stop after exactly `patience` consecutive non-improving validations.
        return self.bad_rounds >= self.patience


@dataclass
class TrainResult:
    state: TrainState
    history: list[dict[str, float]] = field(default_factory=list)
    best_metric: float = -np.inf
    best_step: int = 0
    # End-to-end: examples / total wall time in fit(), validation and
    # checkpoint saves included.
    examples_per_sec: float = 0.0
    # Training phase only: examples / time inside the epoch loops.
    train_examples_per_sec: float = 0.0
    # Steady state: the fastest single epoch.
    steady_examples_per_sec: float = 0.0

    def finalize_throughput(self, examples_seen: int, train_time: float, total_time: float) -> None:
        self.examples_per_sec = examples_seen / max(total_time, 1e-9)
        self.train_examples_per_sec = examples_seen / max(train_time, 1e-9)
        self.steady_examples_per_sec = max(
            (r["examples_per_sec"] for r in self.history if "examples_per_sec" in r),
            default=self.train_examples_per_sec,
        )


def _host_metrics(metrics: dict[str, torch.Tensor]) -> dict[str, float]:
    """One device-to-host read of a metrics dict."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).tolist()
    return dict(zip(keys, values))


class Trainer:
    """Epoch-driving host loop around the train step, on one device
    (``cuda`` unless the caller passes ``device="cpu"``).

    ``evaluate_fn(params) -> dict`` supplies validation metrics (typically
    from ``evaluation.Evaluator``); ``writers`` receive per-step and
    per-epoch metric dicts (``utils/tracking.py``).
    """

    def __init__(
        self,
        config: Config,
        *,
        log_q: np.ndarray | None = None,
        evaluate_fn: Callable[[Any], dict[str, float]] | None = None,
        writers: list[Any] | None = None,
        checkpoint_manager: Any | None = None,
        shutdown: Any | None = None,
        item_tokens: np.ndarray | None = None,
        mesh: Any | None = None,
        num_items: int | None = None,
        text_embedding_init: np.ndarray | None = None,
        device: str | torch.device | None = None,
    ):
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.config = config
        self.optimizer = make_optimizer(config.training)
        self._text_embedding_init = text_embedding_init
        self._step_args = dict(log_q=log_q, item_tokens=item_tokens, num_items=num_items)
        # On a mesh the step is built in fit(), against the state's layout.
        self.train_step = None if mesh is not None else make_train_step(
            config, self.optimizer, log_q, item_tokens=item_tokens, num_items=num_items,
            device=self.device,
        )
        self.evaluate_fn = evaluate_fn
        self.writers = writers or []
        self.checkpoint_manager = checkpoint_manager
        # Preemption-aware stop flag provider (utils.profiling.GracefulShutdown).
        self.shutdown = shutdown

    def init_state(self, num_users: int, num_items: int) -> TrainState:
        from twotower_tpu_torch.training.state import init_train_state

        return init_train_state(
            self.config, self.optimizer, num_users, num_items, mesh=self.mesh,
            text_embedding_init=self._text_embedding_init, device=self.device,
        )

    def _ensure_step(self, state: TrainState) -> None:
        if self.train_step is None:
            args = self._step_args
            self.train_step = make_train_step(
                self.config, self.optimizer, args["log_q"], item_tokens=args["item_tokens"],
                num_items=args["num_items"], mesh=self.mesh, state_template=state,
            )

    def _write(self, payload: dict[str, float], step: int) -> None:
        for w in self.writers:
            w.write(payload, step=step)

    def fit(self, state: TrainState, pipeline, *, start_epoch: int = 0) -> TrainResult:
        from twotower_tpu_torch.data.pipeline import DevicePrefetcher, torch_put
        from twotower_tpu_torch.models.two_tower import dead_row
        from twotower_tpu_torch.training.host_dedup import augment_epoch, wants_host_dedup
        from twotower_tpu_torch.utils.profiling import StepTimer

        cfg = self.config.training
        self._ensure_step(state)
        # The negatives' generator: the same on every rank of a mesh.
        rng = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        stopper = EarlyStopping(patience=cfg.patience)
        result = TrainResult(state=state)
        examples_seen = 0
        t_start = time.perf_counter()
        pending: dict[str, torch.Tensor] | None = None
        timer = StepTimer()
        to_device = torch_put(self.device)

        # Host-side dedup precompute (training/host_dedup.py) on the
        # prefetch thread: the step skips its sort + segment dedup.
        dedup_deads: tuple[int, int | None] | None = None
        if wants_host_dedup(self.config, self.mesh):
            item_dead = (
                dead_row(state.params["item_embedding"])
                if self.config.retrieval.candidate_sampling == "in_batch"
                else None
            )
            dedup_deads = (dead_row(state.params["user_embedding"]), item_dead)

        def epoch_batches(epoch: int):
            it = pipeline.epoch(epoch)
            if dedup_deads is not None:
                it = augment_epoch(it, user_dead=dedup_deads[0], item_dead=dedup_deads[1])
            return it

        # Segmented dispatch (training.segment_steps > 1): S stacked batches
        # a prefetch item, stepped in one runner call.
        seg = cfg.segment_steps if self.mesh is None else 0
        if cfg.segment_steps > 1 and self.mesh is not None:
            logger.warning(
                "training.segment_steps=%d ignored on the mesh path (per-step batches a "
                "rank); use --device-loop for device-resident mesh epochs", cfg.segment_steps,
            )
        segment_run = make_segment_runner(self.train_step) if seg > 1 else None

        train_time = 0.0
        for epoch in range(start_epoch, cfg.epochs):
            t_epoch = time.perf_counter()
            steps = 0
            batches = epoch_batches(epoch)
            source = DevicePrefetcher(
                pack_segments(batches, seg) if seg > 1 else batches, to_device
            )
            for device_batch in source:
                if segment_run is not None:
                    n_steps = int(device_batch["user_idx"].shape[0])
                    rows = int(device_batch["user_idx"].shape[1])
                    state, metrics = segment_run(state, device_batch, rng)
                else:
                    n_steps, rows = 1, int(device_batch["user_idx"].shape[0])
                    state, metrics = self.train_step(state, device_batch, rng)
                timer.tick()
                prev_steps = steps
                steps += n_steps
                examples_seen += n_steps * rows
                # Read the *previous* dispatch's metrics: the device runs this
                # one meanwhile. (Crossing test, not modulo: segments advance
                # by S steps.) Skipped while an async checkpoint copies its
                # snapshot; the epoch-end record reads unconditionally.
                if pending is not None and (
                    prev_steps // cfg.log_every_steps != steps // cfg.log_every_steps
                ) and not getattr(self.checkpoint_manager, "is_busy", False):
                    host = _host_metrics(pending)
                    self._write({f"train/{k}": v for k, v in host.items()}, int(state.step))
                    warn_dropped_ids(host, epoch=epoch, step=int(state.step))
                    logger.info(
                        "epoch %d step %d loss %.4f acc %.4f",
                        epoch, int(state.step), host.get("loss", np.nan),
                        host.get("accuracy", np.nan),
                    )
                pending = metrics
            if pending is not None:
                # Read before the clock stops: the epoch's time then covers
                # its device work, which runs behind the host's dispatch.
                last = _host_metrics(pending)
            epoch_time = time.perf_counter() - t_epoch
            train_time += epoch_time
            eps = steps * cfg.batch_size / max(epoch_time, 1e-9)
            record: dict[str, float] = {"epoch": float(epoch), "examples_per_sec": eps}
            timing = timer.summary()
            if seg > 1:  # ticks are per segment, not per step: say so
                timing = {k.replace("step_time", "segment_time"): v for k, v in timing.items()}
            record.update(timing)
            if pending is not None:
                record.update(last)
                warn_dropped_ids(record, epoch=epoch, step=int(state.step))

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
                    "epoch %d done in %.1fs (%.0f ex/s) %s=%.4f",
                    epoch, epoch_time, eps, cfg.early_stopping_metric, metric,
                )
                improved = metric > stopper.best
                should_stop = stopper.update(metric, int(state.step))
                if improved and self.checkpoint_manager is not None:
                    self.checkpoint_manager.save(
                        int(state.step),
                        state,
                        metrics={cfg.early_stopping_metric: metric},
                        extra={"epoch": epoch + 1},
                    )
                result.history.append(record)
                self._write(record, int(state.step))
                if should_stop:
                    logger.info(
                        "early stopping at epoch %d (best %s=%.4f @ step %d)",
                        epoch, cfg.early_stopping_metric, stopper.best, stopper.best_step,
                    )
                    break
            else:
                logger.info("epoch %d done in %.1fs (%.0f ex/s)", epoch, epoch_time, eps)
                result.history.append(record)
                self._write(record, int(state.step))

            if self.shutdown is not None and self.shutdown.should_stop:
                # Preemption: persist progress before leaving the loop.
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
            # Drain async saves: the best state is durable before fit returns
            # (counted in the end-to-end time, outside the train phase).
            self.checkpoint_manager.flush()
            ensure_final_persisted(
                self.checkpoint_manager, state, stopper,
                epoch=start_epoch + len(result.history),
            )
        total_time = time.perf_counter() - t_start
        result.state = state
        result.best_metric = stopper.best
        result.best_step = stopper.best_step
        result.finalize_throughput(examples_seen, train_time, total_time)
        return result

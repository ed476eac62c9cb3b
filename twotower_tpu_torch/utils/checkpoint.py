"""Checkpoint/resume of the port's train state, in a torch-native format.

Counterpart of ``twotower_tpu/utils/checkpoint.py`` (which writes Orbax
checkpoints). The layout and the rules are the same: ``directory/
step_XXXXXXXXXX/`` holds the state and a ``meta.json`` sidecar (step,
metrics, ``format``, extra keys such as the resume ``epoch``), and
``meta.json`` is written LAST, so its presence marks a complete save. The
state is stored with ``torch.save`` as nested dicts and lists of tensors and
ints (``state.pt``) and loaded with ``weights_only=True``: no pickled objects.

The state layout is the bridge's (``bridge.py``) with tensors in place of
numpy arrays::

    {"step": int, "params": {...}, "opt_state": {"count": int, <slots>},
     "table_state": {table: {"moments": [rows, 2E]}} or None}

``<slots>`` are the optimizer's (``training.state.opt_state_to_tree``):
``mu`` and ``nu`` for adam and adamw, ``sum_of_squares`` for adagrad, none
for sgd. An adam checkpoint therefore has the layout it had before the
other optimizers existed, and restores as it did.

On a mesh (a state with ``sharding``, ``parallel/sharding.py``) saving is
collective: every rank calls ``save``, the shards are gathered, and rank 0
writes the single-device layout, so ``evaluate-model`` and ``serve-model``
read a mesh checkpoint unchanged. ``restore`` into a sharded template reads
that layout and shards it to the mesh at hand (any layout, any world
size). Async saving is off when the world holds more than one process, as
in the JAX package.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import torch

from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.training.state import (
    TrainState,
    opt_state_from_tree,
    opt_state_to_tree,
    tree_map,
)

logger = get_logger(__name__)


def _world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


FORMAT = "twotower_tpu_torch.checkpoint.v1"


def state_to_tree(state: TrainState) -> dict:
    """``TrainState`` -> the nested dict that is saved (tensors shared, not
    copied)."""
    return {
        "step": int(state.step),
        "params": state.params,
        "opt_state": opt_state_to_tree(state.opt_state),
        "table_state": state.table_state,
    }


def tree_to_state(tree: dict) -> TrainState:
    return TrainState(
        step=int(tree["step"]),
        params=tree["params"],
        opt_state=opt_state_from_tree(tree["opt_state"]),
        table_state=tree["table_state"],
    )


def _check_like(loaded: Any, template: Any, path: str = "state") -> None:
    """Raise unless ``loaded`` has the template's structure and shapes."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or sorted(loaded) != sorted(template):
            raise ValueError(f"checkpoint {path}: keys differ from the template")
        for k in template:
            _check_like(loaded[k], template[k], f"{path}/{k}")
    elif isinstance(template, list):
        if not isinstance(loaded, list) or len(loaded) != len(template):
            raise ValueError(f"checkpoint {path}: length differs from the template")
        for i, (a, b) in enumerate(zip(loaded, template)):
            _check_like(a, b, f"{path}/{i}")
    elif template is None:
        if loaded is not None:
            raise ValueError(f"checkpoint {path}: holds a value the template has not")
    elif isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor) or loaded.shape != template.shape:
            raise ValueError(
                f"checkpoint {path}: shape {getattr(loaded, 'shape', None)} != "
                f"template {tuple(template.shape)}"
            )


class CheckpointManager:
    """Keep the last ``keep`` checkpoints under ``directory/step_N/``.

    ``async_save=True`` moves the save off the training thread: ``save``
    snapshots the state on its device (``clone()``, a device-to-device copy;
    the train step may then update the live tensors in place) and hands it
    to a background worker, which copies it to the host and writes it.

    At most ONE snapshot exists at a time: ``save`` requests arriving while
    the worker is busy, or within ``min_interval_s`` of the last accepted
    request, are SKIPPED (no snapshot allocated; logged). The worker frees
    each snapshot tensor as soon as its host copy exists. The best
    checkpoint on disk is then at most one accepted-save interval older than
    the true best validation; ``flush()`` at the end of ``fit`` drains the
    in-flight save, and ``training.loop.ensure_final_persisted`` covers a
    run whose improving saves were all skipped.
    """

    def __init__(
        self,
        directory: str | Path,
        *,
        keep: int = 3,
        async_save: bool = False,
        min_interval_s: float = 0.0,
    ):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        # Saves of a world of several processes are collective and synchronous.
        self.async_save = bool(async_save) and _world()[1] == 1
        if async_save and not self.async_save:
            logger.info("async_save requested but %d processes need the collective "
                        "synchronous save; disabled", _world()[1])
        # Minimum seconds between ACCEPTED save requests (0 = none).
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._pending: tuple | None = None  # newest not-yet-started request
        self._work = threading.Semaphore(0)
        self._idle = threading.Event()
        self._idle.set()
        self._worker: threading.Thread | None = None
        self._worker_err: BaseException | None = None
        # -inf, not 0.0: time.monotonic() is time-since-boot on Linux, so a
        # freshly booted host would otherwise treat the FIRST improving-epoch
        # save as inside the accept interval and skip it.
        self._last_accept = float("-inf")

    @property
    def is_busy(self) -> bool:
        """An async save is queued or being written (advisory: callers may
        defer optional foreground fetches meanwhile)."""
        return not self._idle.is_set()

    # -- async machinery -----------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return

        def loop() -> None:
            while True:
                self._work.acquire()
                with self._lock:
                    req = self._pending
                    self._pending = None
                    if req is None:  # coalesced away
                        self._idle.set()
                        continue
                    self._idle.clear()
                step, snapshot, ready, metrics, extra = req
                del req
                try:
                    if ready is not None:
                        ready.synchronize()  # the snapshot's clones have run
                    host = _to_host_freeing(snapshot)
                    del snapshot
                    self._save_now(step, host, metrics=metrics, extra=extra)
                except BaseException as e:  # surface on the next save/flush
                    logger.exception("async checkpoint save failed at step %d", step)
                    self._worker_err = e
                finally:
                    with self._lock:
                        if self._pending is None:
                            self._idle.set()

        self._worker = threading.Thread(target=loop, name="ckpt-saver", daemon=True)
        self._worker.start()

    def flush(self, timeout: float | None = None) -> None:
        """Block until every pending async save has reached disk (no-op for
        synchronous managers). Raises if the worker failed, and raises
        ``TimeoutError`` if the pending save did not reach disk within
        ``timeout`` seconds."""
        if self._worker is not None and not self._idle.wait(timeout):
            raise TimeoutError(f"async checkpoint save still in flight after {timeout}s")
        if self._worker_err is not None:
            err, self._worker_err = self._worker_err, None
            raise err

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.directory / f"step_{step:010d}"

    def all_steps(self) -> list[int]:
        steps = []
        for p in self.directory.glob("step_*"):
            if not (p / "meta.json").exists():
                continue  # incomplete (crashed mid-save): not restorable
            try:
                steps.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self, metric: str | None = None) -> int | None:
        """The durable step with the highest recorded validation metric
        (``metric`` names a key in the save-time ``metrics`` dict; None
        accepts any sole recorded metric). Steps without a metric (e.g.
        preemption saves) are skipped. A ``post_starvation_final`` backstop
        competes at its ``best_val_at_stop`` PROXY: that value describes a
        lost (skipped-save) step, but the final state is within
        early-stopping patience of it, so when the proxy EXCEEDS every
        genuine durable metric the final state is the expected-best restore.
        Genuine metrics win ties. None when nothing qualifies, in which case
        callers fall back to latest."""
        best: tuple[float, int, bool] | None = None
        for step in self.all_steps():
            try:
                meta = json.loads((self._step_dir(step) / "meta.json").read_text())
            except (OSError, ValueError):
                continue
            metrics = meta.get("metrics") or {}
            proxy = bool(meta.get("post_starvation_final"))
            if proxy:
                value = metrics.get("best_val_at_stop")
            elif metric is not None:
                value = metrics.get(metric)
            elif len(metrics) == 1:
                value = next(iter(metrics.values()))
            else:
                value = None
            if value is None:
                continue
            v = float(value)
            if (
                best is None
                or v > best[0]
                # a genuine metric displaces an equal-valued proxy
                or (v == best[0] and best[2] and not proxy)
            ):
                best = (v, step, proxy)
        return best[1] if best else None

    # ------------------------------------------------------------------

    def save(
        self,
        step: int,
        state: TrainState,
        *,
        metrics: dict[str, float] | None = None,
        extra: dict[str, Any] | None = None,
        force: bool = False,
    ) -> Path:
        """Save state + metadata; prune beyond ``keep`` oldest-first.
        ``force`` bypasses the busy/interval skip (end-of-fit backstop and
        preemption; callers flush() first so only one snapshot exists).

        Async managers return right after the on-device snapshot (see the
        class docstring); call :meth:`flush` to guarantee durability."""
        path = self._step_dir(step)
        if self._worker_err is not None:
            self.flush()  # re-raise a prior async failure
        if state.sharding is not None:
            from twotower_tpu_torch.parallel.sharding import gather_state

            state = gather_state(state)  # collective: every rank is here
            rank, world = _world()
            if world > 1:
                if rank == 0:
                    self._save_now(step, state_to_tree(state), metrics=metrics, extra=extra)
                import torch.distributed as dist

                dist.barrier()  # the save is on disk before any rank goes on
                return path
        if not self.async_save:
            return self._save_now(step, state_to_tree(state), metrics=metrics, extra=extra)
        self._ensure_worker()
        now = time.monotonic()
        if not force:
            if self.is_busy:
                logger.info(
                    "async checkpoint: skipping step %d (a save is in flight; "
                    "one snapshot at a time)", step,
                )
                return path
            if now - self._last_accept < self.min_interval_s:
                logger.info(
                    "async checkpoint: skipping step %d (%.0fs into the %.0fs "
                    "accept interval)", step, now - self._last_accept, self.min_interval_s,
                )
                return path
        self._last_accept = now
        # The snapshot must exist before save returns: the next train step
        # updates the live tensors in place.
        snapshot = tree_map(
            lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
            state_to_tree(state),
        )
        ready = None
        if state.params["user_embedding"].is_cuda:
            # The worker copies on its own thread (another current stream):
            # it waits for this event, recorded after the clones.
            ready = torch.cuda.Event()
            ready.record()
        with self._lock:
            fresh = self._pending is None
            self._pending = (step, snapshot, ready, metrics, extra)
            self._idle.clear()
            if fresh:
                self._work.release()
        return path

    def _save_now(
        self,
        step: int,
        tree: dict,
        *,
        metrics: dict[str, float] | None = None,
        extra: dict[str, Any] | None = None,
    ) -> Path:
        path = self._step_dir(step)
        if (path / "meta.json").exists():
            logger.info("checkpoint step %d already exists, skipping", step)
            return path
        if path.exists():
            logger.warning("removing incomplete checkpoint at %s", path)
            shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)
        torch.save(tree, path / "state.pt")
        meta = {
            "step": step,
            "metrics": metrics or {},
            "format": FORMAT,
            **(extra or {}),
        }
        # meta.json is written LAST: its presence marks the save complete.
        (path / "meta.json").write_text(json.dumps(meta, indent=2))
        self._prune()
        logger.info("saved checkpoint at step %d -> %s", step, path)
        return path

    def restore(
        self, state_template: TrainState, step: int | None = None
    ) -> tuple[TrainState, dict]:
        """Restore onto the template's device, checking its structure and
        shapes; a sharded template gets this rank's shard of the saved
        state. Returns (state, metadata dict)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._step_dir(step)
        template = state_to_tree(state_template)
        sh = state_template.sharding
        device = "cpu" if sh is not None else state_template.params["user_embedding"].device
        tree = torch.load(path / "state.pt", map_location=device, weights_only=True)
        if sh is not None:
            from twotower_tpu_torch.parallel.sharding import shard_tree

            tree = shard_tree(tree, sh.mesh, sh.mesh.config, sparse_mesh=sh.sparse_mesh)
        _check_like(tree, template)
        meta_path = path / "meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        logger.info("restored checkpoint step %d from %s", step, path)
        state = tree_to_state(tree)
        state.sharding = sh
        return state, meta

    def _prune(self) -> None:
        steps = self.all_steps()
        for step in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
            logger.debug("pruned checkpoint step %d", step)


def _to_host_freeing(tree: Any) -> Any:
    """Host copy of a snapshot tree, dropping each device tensor as soon as
    its host copy exists (the snapshot is referenced nowhere else, so its
    device memory decays to zero over the copy)."""
    if isinstance(tree, dict):
        return {k: _to_host_freeing(tree.pop(k)) for k in list(tree)}
    if isinstance(tree, list):
        out = []
        while tree:
            out.append(_to_host_freeing(tree.pop(0)))
        return out
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    return tree

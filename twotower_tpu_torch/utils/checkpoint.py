"""Checkpoint/resume of the port's train state, in a torch-native format.

Counterpart of ``twotower_tpu/utils/checkpoint.py`` (which writes Orbax
checkpoints). The layout and the rules are the same: ``directory/
step_XXXXXXXXXX/`` holds the state and a ``meta.json`` sidecar (step,
metrics, ``format``, extra keys such as the resume ``epoch``), and
``meta.json`` is written LAST, so its presence marks a complete save.

The state is the bridge's layout (``bridge.py``) with tensors in place of
numpy arrays::

    {"step": int, "params": {...}, "opt_state": {"count": int, <slots>},
     "table_state": {table: {"moments": [rows, 2E]}} or None}

``<slots>`` are the optimizer's (``training.state.opt_state_to_tree``):
``mu`` and ``nu`` for adam and adamw, ``sum_of_squares`` for adagrad, none
for sgd.

Format ``twotower_tpu_torch.checkpoint.v2``: ``manifest.json`` holds the
tree's structure (tensors replaced by their ``/``-joined paths, ints and
None as they are) and, for each tensor, its global shape, dtype, sharded
axis and the files that hold its rows: ``rank_XXXXX.pt``, one
``torch.save`` file of ``{path: tensor}`` for each rank that wrote, loaded
with ``weights_only=True`` (no pickled objects). On a mesh (a state with
``sharding``, ``parallel/sharding.py``) saving is collective and each rank
writes only what it owns: a table leaf's rows by the lowest rank holding
them (every rank on the sparse path's combined axis; the ``data``-index-0
peer of each model shard on the dense path), the replicated leaves by rank
0, which writes the manifest and ``meta.json`` after a barrier. Async
saving is off when the world holds more than one process, as in the JAX
package. One device writes the same layout with one file.

``restore`` reads, for each leaf of the template, only the rows the
template holds (this rank's shard at the template's layout, whatever the
saved one; every row for a template without sharding), through
``torch.load(..., mmap=True)``, and copies them into the template's
tensors: no rank loads a file whole or holds another rank's rows.
``evaluate-model`` and ``serve-model`` therefore read a mesh checkpoint on
one device. A ``v1`` step (one ``state.pt`` of the whole tree) restores the
same way.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import TYPE_CHECKING, Any

import torch

from twotower_tpu_torch.logging_utils import get_logger

if TYPE_CHECKING:
    from twotower_tpu_torch.training.state import TrainState

logger = get_logger(__name__)


def _world() -> tuple[int, int]:
    """``(rank, world size)`` of the process group, ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


FORMAT = "twotower_tpu_torch.checkpoint.v2"
MANIFEST = "manifest.json"
LEGACY_STATE = "state.pt"  # a v1 step: the whole tree in one file


def state_to_tree(state: TrainState) -> dict:
    """``TrainState`` -> the nested dict that is saved (tensors shared, not
    copied)."""
    # training.state imports utils (the package imports this module): late.
    from twotower_tpu_torch.training.state import opt_state_to_tree

    return {
        "step": int(state.step),
        "params": state.params,
        "opt_state": opt_state_to_tree(state.opt_state),
        "table_state": state.table_state,
    }


def tree_to_state(tree: dict) -> TrainState:
    from twotower_tpu_torch.training.state import TrainState, opt_state_from_tree

    return TrainState(
        step=int(tree["step"]),
        params=tree["params"],
        opt_state=opt_state_from_tree(tree["opt_state"]),
        table_state=tree["table_state"],
    )


def _shard_file(rank: int) -> str:
    return f"rank_{rank:05d}.pt"


def _leaves(tree: Any, path: tuple = ()):
    """``(path, leaf)`` of every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, (*path, i))
    else:
        yield path, tree


def _key(path: tuple) -> str:
    return "/".join(map(str, path))


def _skeleton(tree: Any, path: tuple = ()) -> Any:
    """The tree for ``manifest.json``: each tensor replaced by
    ``{"tensor": path}``."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_skeleton(v, (*path, i)) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        return {"tensor": _key(path)}
    return tree


def _is_tensor_ref(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"tensor"}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host(t: torch.Tensor) -> torch.Tensor:
    """A host tensor that owns exactly its elements (``torch.save`` writes a
    view's whole storage)."""
    t = t.detach()
    if t.device.type != "cpu":
        return t.cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        return t.clone()
    return t


def _axis_index(mesh, axis: str, rank: int) -> int:
    """Rank ``rank``'s index on a table axis (ranks are data-major)."""
    return {"combined": rank, "model": rank % mesh.num_model}[axis]


def _layout(tree: dict, sharding) -> tuple[dict, dict]:
    """Where each tensor leaf goes: ``({path: manifest entry}, {rank: [paths
    it writes]})``. Without ``sharding`` rank 0 writes every leaf whole; on
    a mesh each shard of a table leaf is written by the lowest rank that
    holds it (its rows are ``[index * n, (index + 1) * n)``) and the
    replicated leaves by rank 0."""
    from twotower_tpu_torch.parallel.sharding import leaf_axes

    axes = (None if sharding is None else
            leaf_axes(tree, sharding.mesh.config, sparse_mesh=sharding.sparse_mesh))
    entries, writes = {}, {}
    for path, leaf in _leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        axis = None
        if axes is not None:
            node = axes
            for k in path:
                node = node[k]
            axis = node
        key = _key(path)
        shape = list(leaf.shape)
        if axis is None:
            parts = [[_shard_file(0), 0, shape[0] if shape else 0]]
            writes.setdefault(0, []).append(key)
        else:
            mesh = sharding.mesh
            n, size = shape[0], mesh.axis(axis).size
            parts = []
            for i in range(size):
                writer = min(r for r in range(mesh.world) if _axis_index(mesh, axis, r) == i)
                parts.append([_shard_file(writer), i * n, (i + 1) * n])
                writes.setdefault(writer, []).append(key)
            shape[0] = n * size
        entries[key] = {"shape": shape, "dtype": _dtype_name(leaf.dtype),
                        "axis": axis, "parts": parts}
    return entries, writes


class _Source:
    """The saved tensors of one step, read lazily: ``rows(key, lo, hi)``
    gives rows ``[lo, hi)`` of a leaf's global tensor from the files that
    hold them, each file opened once with ``mmap=True``."""

    def __init__(self, path: Path):
        self.path = path
        self._files: dict[str, dict] = {}
        if (path / LEGACY_STATE).exists():  # v1: the whole tree, one file
            tree = self._open(LEGACY_STATE)
            self.skeleton = _skeleton(tree)
            self.entries = {
                _key(p): {"shape": list(t.shape), "dtype": _dtype_name(t.dtype),
                          "parts": [[LEGACY_STATE, 0, t.shape[0] if t.dim() else 0]]}
                for p, t in _leaves(tree) if isinstance(t, torch.Tensor)}
            self._flat = {LEGACY_STATE: {_key(p): t for p, t in _leaves(tree)
                                         if isinstance(t, torch.Tensor)}}
        else:
            manifest = json.loads((path / MANIFEST).read_text())
            self.skeleton, self.entries = manifest["tree"], manifest["leaves"]
            self._flat = {}

    def _open(self, name: str):
        if name not in self._files:
            self._files[name] = torch.load(self.path / name, map_location="cpu",
                                           weights_only=True, mmap=True)
        return self._files[name]

    def tensor(self, name: str, key: str) -> torch.Tensor:
        if name not in self._flat:
            self._flat[name] = self._open(name)
        return self._flat[name][key]

    def copy_rows(self, key: str, out: torch.Tensor, lo: int) -> None:
        """``out[:] = `` rows ``[lo, lo + len(out))`` of the saved leaf (all of
        it for a 0-d leaf)."""
        if out.dim() == 0:
            out.copy_(self.tensor(self.entries[key]["parts"][0][0], key))
            return
        hi = lo + out.shape[0]
        for name, a, b in self.entries[key]["parts"]:
            x, y = max(a, lo), min(b, hi)
            if x < y:
                out[x - lo:y - lo].copy_(self.tensor(name, key)[x - a:y - a])


def _plan(saved: Any, template: Any, axes: Any, source: _Source, sharding,
          path: str = "state") -> list:
    """Check the saved tree against the template (structure, each leaf's
    dtype, and its global shape against the template's shard times its
    axis size) and return the copies ``[(key, template tensor, first
    global row)]``."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or _is_tensor_ref(saved) or \
                sorted(saved) != sorted(template):
            raise ValueError(f"checkpoint {path}: keys differ from the template")
        return [c for k in template for c in _plan(saved[k], template[k], axes[k], source,
                                                   sharding, f"{path}/{k}")]
    if isinstance(template, list):
        if not isinstance(saved, list) or len(saved) != len(template):
            raise ValueError(f"checkpoint {path}: length differs from the template")
        return [c for i, (a, b) in enumerate(zip(saved, template))
                for c in _plan(a, b, axes[i], source, sharding, f"{path}/{i}")]
    if template is None:
        if saved is not None:
            raise ValueError(f"checkpoint {path}: holds a value the template has not")
        return []
    if not isinstance(template, torch.Tensor):
        return []
    if not _is_tensor_ref(saved):
        raise ValueError(f"checkpoint {path}: holds no tensor where the template has one")
    key = saved["tensor"]
    shape, lo = list(template.shape), 0
    if axes is not None:
        ax = sharding.mesh.axis(axes)
        lo, shape[0] = ax.index * shape[0], shape[0] * ax.size
    entry = source.entries[key]
    if entry["shape"] != shape:
        raise ValueError(f"checkpoint {path}: shape {tuple(entry['shape'])} != "
                         f"template {tuple(shape)}")
    if entry["dtype"] != _dtype_name(template.dtype):
        raise ValueError(f"checkpoint {path}: dtype {entry['dtype']} != template "
                         f"{_dtype_name(template.dtype)}")
    return [(key, template, lo)]


def _rebuild(saved: Any, template: Any) -> Any:
    """The restored tree: the template's tensors (now holding the saved
    values) and the saved ints."""
    if isinstance(template, dict):
        return {k: _rebuild(saved[k], template[k]) for k in template}
    if isinstance(template, list):
        return [_rebuild(a, b) for a, b in zip(saved, template)]
    if isinstance(template, torch.Tensor):
        return template
    return saved


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
            return self._save_sharded(step, state, metrics=metrics, extra=extra)
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
        from twotower_tpu_torch.training.state import tree_map

        snapshot = tree_map(
            lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
            state_to_tree(state),
        )
        ready = None
        if state.params["item_embedding"].is_cuda:
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
        """Write a whole tree (one device) as one file."""
        path = self._step_dir(step)
        if (path / "meta.json").exists():
            logger.info("checkpoint step %d already exists, skipping", step)
            return path
        self._fresh_dir(path)
        entries, _ = _layout(tree, None)
        torch.save({k: _host(t) for k, t in ((_key(p), t) for p, t in _leaves(tree))
                    if k in entries}, path / _shard_file(0))
        return self._finish(step, tree, entries, metrics, extra)

    def _save_sharded(self, step: int, state: TrainState, *, metrics, extra) -> Path:
        """The collective save of a mesh state: each rank writes the leaves
        (and table row shards) it owns, then rank 0 writes the manifest and
        ``meta.json`` (module docstring). Every rank calls it."""
        import torch.distributed as dist

        path = self._step_dir(step)
        rank = state.sharding.mesh.rank
        tree = state_to_tree(state)
        if (path / "meta.json").exists():  # every rank sees the same directory
            logger.info("checkpoint step %d already exists, skipping", step)
            return path
        if rank == 0:
            self._fresh_dir(path)
        dist.barrier()  # the directory exists, empty
        entries, writes = _layout(tree, state.sharding)
        mine = set(writes.get(rank, ()))
        if mine:
            torch.save({k: _host(t) for k, t in ((_key(p), t) for p, t in _leaves(tree))
                        if k in mine}, path / _shard_file(rank))
        dist.barrier()  # every shard is on disk
        if rank == 0:
            self._finish(step, tree, entries, metrics, extra)
        dist.barrier()  # the step is complete before any rank goes on
        return path

    def _fresh_dir(self, path: Path) -> None:
        if path.exists():
            logger.warning("removing incomplete checkpoint at %s", path)
            shutil.rmtree(path, ignore_errors=True)
        path.mkdir(parents=True)

    def _finish(self, step: int, tree: dict, entries: dict, metrics, extra) -> Path:
        """The manifest, then ``meta.json`` (its presence marks the save
        complete), then pruning."""
        path = self._step_dir(step)
        (path / MANIFEST).write_text(json.dumps({"tree": _skeleton(tree), "leaves": entries}))
        meta = {
            "step": step,
            "metrics": metrics or {},
            "format": FORMAT,
            **(extra or {}),
        }
        (path / "meta.json").write_text(json.dumps(meta, indent=2))
        self._prune()
        logger.info("saved checkpoint at step %d -> %s", step, path)
        return path

    def restore(
        self, state_template: TrainState, step: int | None = None
    ) -> tuple[TrainState, dict]:
        """Restore into the template (its tensors receive the saved values,
        on their device), checking its structure, dtypes and shapes; a
        sharded template gets this rank's shard of the saved state, read
        row range by row range from the files that hold it. Returns (state,
        metadata dict)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._step_dir(step)
        template = state_to_tree(state_template)
        sh = state_template.sharding
        source = _Source(path)
        if sh is None:
            from twotower_tpu_torch.training.state import tree_map

            axes = tree_map(lambda _: None, template)
        else:
            from twotower_tpu_torch.parallel.sharding import leaf_axes

            axes = leaf_axes(template, sh.mesh.config, sparse_mesh=sh.sparse_mesh)
        with torch.no_grad():
            for key, out, lo in _plan(source.skeleton, template, axes, source, sh):
                source.copy_rows(key, out, lo)
        meta_path = path / "meta.json"
        meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        logger.info("restored checkpoint step %d from %s", step, path)
        state = tree_to_state(_rebuild(source.skeleton, template))
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

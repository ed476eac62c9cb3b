"""Spawn ``gloo`` ranks on the CPU for the port's mesh tests.

``run_ranks(target, world, workdir, *args)`` starts ``world`` processes
(``torch.multiprocessing``, from a fork server that has imported torch
and the port once), each joining a ``gloo`` group through a
``file://`` store under ``workdir`` (no TCP port, so parallel test workers
never collide) with one intra-op thread, and calls ``target(rank, world,
workdir, *args)``, a module-level function of a module that imports no JAX
(the ranks then start in a fraction of a second). A rank's return value, a nested
dict of tensors, arrays and numbers, is flattened (``flatten``: keys joined
by ``/``) into ``workdir/rank{r}.npz``; the parent reads the flat dicts back. The spawn has its own timeout: past it the ranks are
killed and the test fails, so a hang costs one test, not the suite.
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np

TIMEOUT_S = 120


def _rank_main(target, rank: int, world: int, workdir: str, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.pop("RANK", None)
    out = Path(workdir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{out / 'store'}",
                                rank=rank, world_size=world)
        result = flatten(target(rank, world, workdir, *args))
        np.savez(out / f"rank{rank}.npz", **result)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def run_ranks(target, world: int, workdir, *args, timeout: float = TIMEOUT_S) -> list:
    """Run ``target`` on ``world`` gloo ranks; their results, by rank."""
    import torch.multiprocessing as mp

    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("forkserver")
    # The fork server imports torch and the port once; each rank forks from
    # it in a fraction of a second instead of importing them again.
    ctx.set_forkserver_preload(["torch", "torch_mesh_workers"])
    procs = [ctx.Process(target=_rank_main, args=(target, r, world, str(workdir), args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(5)
    errs = {r: (workdir / f"rank{r}.err").read_text()
            for r in range(world) if (workdir / f"rank{r}.err").exists()}
    if alive:
        raise AssertionError(f"{len(alive)} of {world} ranks still running after the "
                             f"timeout; killed. Errors: {errs}")
    if errs or any(p.exitcode for p in procs):
        raise AssertionError(f"rank failures (exit codes {[p.exitcode for p in procs]}): "
                             f"{errs}")
    out = []
    for r in range(world):
        with np.load(workdir / f"rank{r}.npz") as f:
            out.append({k: f[k] for k in f.files})
    return out


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict/list of tensors, arrays and numbers -> ``{"a/b/0": array}``
    (None leaves dropped)."""
    import torch

    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif tree is None:
        return {}
    else:
        if isinstance(tree, torch.Tensor):
            tree = tree.detach().float().cpu().numpy() if tree.dtype == torch.bfloat16 \
                else tree.detach().cpu().numpy()
        return {prefix: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out

"""Scaling-efficiency benchmark: examples a second of the mesh step at
several world sizes, and the efficiency against the smallest.

Counterpart of ``twotower_tpu/parallel/scaling.py``, one process a rank
(``gloo`` on the CPU, ``nccl`` with one card a rank): ``run_scaling``
starts ``n`` ranks for each world size ``n`` (skipping, with a warning, a
world larger than the devices available: the visible cards, or the CPU's
cores), each joins a process group through a file store and runs
``measure_mesh``; rank 0's result comes back. On the CPU it checks the
machinery end to end (its times are not the card's).

CLI: ``python -m twotower_tpu_torch.parallel.scaling [--devices 1 2 4 8]
[--device cuda|cpu] ...``; prints one JSON list, JAX's keys.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

RANK_TIMEOUT_S = 900


def measure_mesh(
    config,
    n_devices: int,
    *,
    num_users: int,
    num_items: int,
    steps: int = 30,
    warmup: int = 5,
    device: str = "cuda",
) -> dict:
    """Examples a second of the mesh train step on this process group's
    ``n_devices`` ranks (collective: every rank calls it). The batch is the
    config's, global (each rank takes its data shard); ``mesh.num_model`` is
    2 on an even world of two or more ranks, else 1 (JAX's rule). Times the
    ``steps`` after ``warmup`` with the device synchronised at both ends."""
    from twotower_tpu_torch.parallel import build_mesh
    from twotower_tpu_torch.parallel.sharding import data_rows
    from twotower_tpu_torch.parallel.sparse_spmd import use_sparse_mesh_path
    from twotower_tpu_torch.training.loop import make_raw_step
    from twotower_tpu_torch.training.state import init_train_state, make_optimizer

    cfg = config.with_overrides(
        {"mesh.num_model": 2 if n_devices % 2 == 0 and n_devices > 1 else 1,
         "mesh.num_data": -1})
    sparse = use_sparse_mesh_path(cfg)
    mesh = build_mesh(cfg.mesh, device=device)
    if mesh.world != n_devices:
        raise ValueError(f"the process group holds {mesh.world} ranks, not {n_devices}")
    optimizer = make_optimizer(cfg.training)
    state = init_train_state(cfg, optimizer, num_users, num_items, mesh=mesh)
    step = make_raw_step(cfg, optimizer, num_items=num_items, mesh=mesh, state_template=state)
    bs = cfg.training.batch_size
    rng = np.random.default_rng(0)
    batch = {
        "user_idx": torch.as_tensor(rng.integers(0, num_users, bs).astype(np.int32)),
        "item_idx": torch.as_tensor(rng.integers(0, num_items, bs).astype(np.int32)),
        "weight": torch.ones(bs),
    }
    batch = {k: data_rows(mesh, v).to(mesh.device) for k, v in batch.items()}
    gen = torch.Generator(device=mesh.device).manual_seed(1)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        mesh.combined.all_reduce(torch.zeros(1, device=mesh.device))  # every rank done

    for _ in range(warmup):
        state, metrics = step(state, batch, gen)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, batch, gen)
    sync()
    dt = time.perf_counter() - t0
    return {
        "devices": n_devices,
        "mesh": {cfg.mesh.data_axis: mesh.num_data, cfg.mesh.model_axis: mesh.num_model},
        "global_batch": bs,
        "examples_per_sec": round(steps * bs / dt, 1),
        "step_ms": round(dt / steps * 1e3, 3),
        "sparse_path": sparse,
    }


def _rank_main(rank: int, world: int, store: str, out: str, config, kw: dict) -> None:
    """One rank of ``run_scaling``: join the group, measure, rank 0 writes
    the result."""
    import torch.distributed as dist

    from twotower_tpu_torch.parallel.mesh import default_backend

    device = kw["device"]
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group(default_backend(device), init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        result = measure_mesh(config, world, **kw)
        if rank == 0:
            Path(out).write_text(json.dumps(result))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def devices_available(device: str) -> int:
    """Ranks a world may have: one a visible card, or one a CPU core."""
    if device == "cpu":
        return os.cpu_count() or 1
    return torch.cuda.device_count()


def _run_world(config, n: int, kw: dict) -> dict:
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="scaling_") as tmp:
        out = Path(tmp) / "result.json"
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, str(Path(tmp) / "store"), str(out), config, kw))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        if hung or any(p.exitcode for p in procs) or not out.exists():
            raise RuntimeError(f"scaling world {n}: rank exit codes "
                               f"{[p.exitcode for p in procs]} ({len(hung)} killed)")
        return json.loads(out.read_text())


def run_scaling(config, device_counts: list[int], *, device: str = "cuda", **kw) -> list[dict]:
    """``measure_mesh`` at each world size (one process a rank), with the
    efficiency of each against the first measured one: examples a second a
    rank over the first's."""
    from twotower_tpu_torch.utils.platform import resolve_device

    device = resolve_device(device).type
    available = devices_available(device)
    results = []
    base_eps_per_dev = None
    for n in device_counts:
        if n > available:
            logger.warning("skipping %d devices (only %d available)", n, available)
            continue
        r = _run_world(config, n, {**kw, "device": device})
        per_dev = r["examples_per_sec"] / n
        if base_eps_per_dev is None:
            base_eps_per_dev = per_dev
        r["efficiency"] = round(per_dev / base_eps_per_dev, 3)
        results.append(r)
        logger.info(
            "%d devices: %.0f ex/s (%.1f%% efficiency)",
            n, r["examples_per_sec"], 100 * r["efficiency"],
        )
    return results


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.config import load_config, parse_cli_overrides

    setup_logging()
    p = argparse.ArgumentParser(prog="scaling-bench")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--devices", nargs="*", type=int, default=[1, 2, 4, 8])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: one card a rank over nccl (default); cpu: gloo ranks")
    p.add_argument("--num-users", type=int, default=100_000)
    p.add_argument("--num-items", type=int, default=50_000)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--warmup", type=int, default=5)
    args = p.parse_args(argv)
    config = load_config(args.config, parse_cli_overrides(args.override))
    results = run_scaling(
        config,
        args.devices,
        device=args.device,
        num_users=args.num_users,
        num_items=args.num_items,
        steps=args.steps,
        warmup=args.warmup,
    )
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

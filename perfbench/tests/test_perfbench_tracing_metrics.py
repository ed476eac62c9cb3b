"""The per-layer metrics that read the program's own tracing
(``harness/spans.py``): each on a snapshot made by hand gives the median or
the sum it names, nothing on an empty one or where the program keeps no
snapshot, and the serving ones read a real traced window of
``CoalescedRoutes`` on the CPU."""

import asyncio
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.harness.manifest import load_module
from twotower_tpu_torch.utils import profiling
from twotower_tpu_torch.utils.profiling import Record

BENCH = Path(__file__).resolve().parents[1]
MS = 1_000_000
PHASES = {"gather": 0.15, "forward": 0.5, "backward": 1.6, "optimizer": 0.2, "rows": 0.9}
SERVE = ("batcher.queue_wait_ms.serve", "batcher.dispatch_gap_ms.serve",
         "index.launch_ms.serve", "serve.host_us_per_request.serve")


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def rec(name, start_ms, end_ms, thread=1, request=None):
    return Record(name, 0, None, request, thread, int(start_ms * MS), int(end_ms * MS))


def index_call(t, h2d, tower, search, thread=1):
    """One ``recommend`` call's four spans from ``t`` ms, the wait 20 ms."""
    a, b, c = t + h2d, t + h2d + tower, t + h2d + tower + search
    return [rec("index.h2d", t, a, thread), rec("index.user_tower", a, b, thread),
            rec("index.search", b, c, thread), rec("index.d2h", c, c + 20, thread)]


SNAPSHOT = {
    "records": [
        rec("batcher.queue_wait", 0, 1), rec("batcher.queue_wait", 0, 2),
        rec("batcher.queue_wait", 5, 15),
        rec("batcher.dispatch_gap", 0, 3), rec("batcher.dispatch_gap", 10, 15),
        # a call the window cut (no h2d), then 1+2+3, 1+1+2 and, on another thread, 3+3+3 ms
        rec("index.search", 0, 7), rec("index.d2h", 7, 9),
        *index_call(10, 1, 2, 3), *index_call(40, 1, 1, 2), *index_call(70, 3, 3, 3, thread=2),
        # two requests: prepare 0-1 and 1-2 ms, a collect 2-4 holding a nested
        # prepare, scatter 5-6, filter and format 6-7 and 7-8: 7 ms of loop time
        rec("serve.prepare", 0, 1), rec("serve.prepare", 1, 2), rec("batcher.collect", 2, 4),
        rec("serve.prepare", 2.5, 3), rec("batcher.scatter", 5, 6), rec("serve.filter", 6, 6.5),
        rec("serve.format", 6.5, 7), rec("serve.filter", 7, 7.5), rec("serve.format", 7.5, 8),
    ],
    "dropped": 0, "phases_ms": PHASES,
}
EXPECTED = {
    "batcher.queue_wait_ms.serve": 2.0,
    "batcher.dispatch_gap_ms.serve": 4.0,
    "index.launch_ms.serve": 6.0,
    "serve.host_us_per_request.serve": 7000.0 / 2,
    **{f"step.{p}_ms.train": v for p, v in PHASES.items()},
}
EMPTY = {"records": [], "dropped": 0, "phases_ms": {}}


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("snap", ["fixture", "empty", "no_snapshot"])
def test_reader(monkeypatch, name, snap):
    if snap == "no_snapshot":  # a program without the tracing module's snapshot
        monkeypatch.delattr(profiling, "snapshot")
    else:
        monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT if snap == "fixture" else EMPTY)
    got = metric(name).read(None)
    if snap == "fixture":
        assert got == pytest.approx(EXPECTED[name])
    else:
        assert got is None


def test_serving_readers_read_a_traced_window_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import CoalescedRoutes, RecommendService

    cfg = Config().with_overrides({"model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
                                   "model.item_tower_dims": [32, 16]})
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 100, 60)
    index = RetrievalIndex(cfg, params, 100, 60, device="cpu")
    vocab = type("Vocab", (), {"items": type("Items", (), {
        "decode": staticmethod(lambda idx: np.asarray(idx))})()})()
    routes = CoalescedRoutes(RecommendService(index, vocab, default_k=5, max_batch=8),
                             window_ms=5.0)

    async def go():
        return await asyncio.gather(*(routes.recommend({"user_idx": [u], "k": 5})
                                      for u in range(40)))

    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            asyncio.run(go())
        values = {name: metric(name).read(None) for name in SERVE}
    finally:
        profiling.reset()
    assert all(v is not None and v > 0 for v in values.values()), values

"""The port's spans, marks and step phases (``utils/profiling.py``) on the
CPU: off, they reach no torch call and record nothing; on (any
``torch.profiler``, ``trace(logdir)`` included), they carry their parents
and request ids into the buffer and their names into the profiler, and a
collection in the middle of a record cannot stall the recorder;
``CoalescedRoutes`` traces each request, group and index call; the device
loop's step marks its phase boundaries in order, and on the CPU they cost
nothing."""

import asyncio
import gc
import json
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.serving import RetrievalIndex
from twotower_tpu_torch.serving.api import CoalescedRoutes, RecommendService
from twotower_tpu_torch.training import make_optimizer
from twotower_tpu_torch.training.device_loop import (
    DeviceDataset,
    DeviceTrainer,
    make_epoch_fn,
)
from twotower_tpu_torch.training.state import TrainState
from twotower_tpu_torch.utils import profiling

CFG = Config().with_overrides({
    "model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16], "model.compute_dtype": "float32",
    "training.batch_size": 32, "training.epochs": 1,
})
INDEX_SPANS = ("index.h2d", "index.user_tower", "index.search", "index.d2h")


@pytest.fixture(autouse=True)
def clean_buffer():
    profiling.reset()
    profiling.RECORDER.phases = None
    yield
    profiling.reset()
    profiling.RECORDER.phases = None


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


def _raise(*args, **kwargs):
    raise AssertionError("a span that is off reached torch.profiler")


def test_off_reaches_no_torch_call_and_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(profiling, "_FAST_RANGE", _raise)
    assert not profiling.tracing()
    first = profiling.span("a", request=1)
    assert profiling.span("b") is first  # one shared no-op
    with first, profiling.span("c"):
        profiling.mark("m", 0, 1, request=2, parent=3)
    assert profiling.snapshot() == {"records": [], "dropped": 0, "phases_ms": {}}


def _nested_spans():
    with profiling.span("outer", request=7) as outer:
        with profiling.span("inner", request=7) as inner:
            profiling.mark("waited", 10, 20, request=8, parent=outer.id)
        with ThreadPoolExecutor(1) as pool:  # on in every thread, no parent there
            pool.submit(_elsewhere).result()
    gc.collect()  # a collection is a span too
    return outer, inner


def _elsewhere():
    with profiling.span("elsewhere"):
        pass


@pytest.mark.parametrize("switch", ["profiler", "trace_logdir"])
def test_on_records_parents_requests_and_profiler_names(switch, tmp_path):
    if switch == "profiler":
        with _profiler() as prof:
            assert profiling.tracing()
            outer, inner = _nested_spans()
        names = {e.name for e in prof.events()}
        assert {"outer", "inner", "gc.gen2"} <= names
    else:
        with profiling.trace(tmp_path):
            assert profiling.tracing()
            outer, inner = _nested_spans()
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        ours = [e for e in events if e.get("cat") == "span"]
        assert sorted(e["name"] for e in ours if not e["name"].startswith("gc.")) == [
            "elsewhere", "inner", "outer", "waited"]
        profiled = {e["name"]: e for e in events if e.get("cat") in ("user_annotation", "cpu_op")}
        copy = next(e for e in ours if e["name"] == "outer")
        # the copy sits on the profiler's clock, within its own range's length
        assert abs(copy["ts"] - profiled["outer"]["ts"]) < max(profiled["outer"]["dur"], 200)
    assert not profiling.tracing()
    snap = profiling.snapshot()
    by_name = {r.name: r for r in snap["records"]}
    assert by_name["outer"].parent is None and by_name["inner"].parent == outer.id
    assert by_name["inner"].id == inner.id and by_name["inner"].request == 7
    assert by_name["waited"][2:4] == (outer.id, 8)
    assert (by_name["waited"].start_ns, by_name["waited"].end_ns) == (10, 20)
    assert by_name["elsewhere"].parent is None
    assert by_name["elsewhere"].thread != by_name["outer"].thread
    assert by_name["gc.gen2"].parent is None and by_name["gc.gen2"].start_ns > by_name["outer"].end_ns
    assert by_name["outer"].start_ns <= by_name["inner"].start_ns
    assert by_name["inner"].end_ns <= by_name["outer"].end_ns


@pytest.mark.parametrize("kind", ["span", "mark"])
def test_buffer_is_bounded_and_counts_drops(kind, monkeypatch):
    rec = profiling.Recorder(limit=3)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    with _profiler():
        for i in range(5):
            if kind == "span":
                with profiling.span("x", request=i):
                    pass
            else:
                profiling.mark("x", i, i + 1, request=i)
    snap = rec.snapshot()
    assert [r.request for r in snap["records"]] == [0, 1, 2] and snap["dropped"] == 2
    assert all(isinstance(r, profiling.Record) for r in snap["records"])
    rec.reset()
    assert rec.snapshot() == {"records": [], "dropped": 0, "phases_ms": {}}


@pytest.mark.parametrize("reader", ["span", "snapshot"])
def test_a_collection_inside_a_record_does_not_stall_it(reader):
    """With a collection at nearly every allocation, the collector's
    callback records ``gc.gen<N>`` spans from inside spans, marks and
    snapshots on the same thread; each must run to its end."""
    def work():
        for i in range(300):
            with profiling.span("outer", request=i):
                profiling.mark("m", 0, 1, request=i)
                [[] for _ in range(3)]  # allocations that collect
            if reader == "snapshot" and i % 100 == 0:
                profiling.snapshot()  # its copies allocate, and collect

    threshold = gc.get_threshold()
    with _profiler():
        gc.set_threshold(1)
        try:
            worker = threading.Thread(target=work, daemon=True)
            worker.start()
            worker.join(timeout=60)
        finally:
            gc.set_threshold(*threshold)
    assert not worker.is_alive(), "a record stalled inside a collection"
    names = {r.name for r in profiling.snapshot()["records"]}
    assert {"outer", "m", "gc.gen0"} <= names


def _routes(num_users=100, num_items=60):
    params = two_tower.init_params(torch.Generator().manual_seed(0), CFG.model, num_users,
                                   num_items)
    index = RetrievalIndex(CFG, params, num_users, num_items, device="cpu")
    index.vocab = type("Vocab", (), {})()
    index.vocab.items = type("Items", (), {"decode": staticmethod(lambda idx: np.asarray(idx))})()
    service = RecommendService(index, index.vocab, default_k=5, max_batch=8)
    return CoalescedRoutes(service, window_ms=5.0)


def test_coalesced_routes_trace_requests_groups_and_index_calls():
    routes = _routes()
    batcher = routes.batchers["recommend"]

    async def go():
        first = [routes.recommend({"user_idx": [u], "k": 5}) for u in range(20)]
        out = await asyncio.gather(*first)
        out += await asyncio.gather(*(routes.recommend({"user_idx": [u], "k": 3})
                                      for u in range(20, 23)))
        return out

    before = batcher.batches
    with _profiler() as prof:
        results = asyncio.run(go())
    groups = batcher.batches - before
    assert len(results) == 23 and groups >= 3
    snap = profiling.snapshot()
    recs = snap["records"]

    def named(name):
        return [r for r in recs if r.name == name]

    formats = named("serve.format")
    waits = named("batcher.queue_wait")
    assert len(formats) == len(waits) == 23
    assert {r.request for r in waits} == {r.request for r in formats}
    for name in ("serve.prepare", "serve.filter"):
        assert {r.request for r in named(name)} == {r.request for r in formats}
    collects = named("batcher.collect")
    calls_in_flight = named("batcher.device_call")
    assert len(collects) == len(named("batcher.scatter")) == len(calls_in_flight) == groups
    assert {r.parent for r in waits} == {r.request for r in collects}  # request -> its group
    assert len(named("batcher.dispatch_gap")) == groups - 1  # none before the first call
    calls = sorted((r for r in recs if r.name.startswith("index.")), key=lambda r: r.start_ns)
    assert len(calls) == 4 * groups
    for i in range(0, len(calls), 4):  # each call tiled by its four spans, in order
        call = calls[i:i + 4]
        assert tuple(r.name for r in call) == INDEX_SPANS
        assert len({r.thread for r in call}) == 1
        assert all(a.end_ns <= b.start_ns for a, b in zip(call, call[1:]))
        assert any(c.start_ns <= call[0].start_ns and call[-1].end_ns <= c.end_ns
                   for c in calls_in_flight)  # the loop's span holds the executor's call
    names = {e.name for e in prof.events()}  # the event loop's spans reach the profiler
    assert {"serve.prepare", "serve.filter", "serve.format", "batcher.collect",
            "batcher.device_call", "batcher.scatter"} <= names


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: each record advances a clock by
    ``tick`` ms and keeps the order it was recorded in."""

    order: list = []
    clock, tick = 0.0, 1.0

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        FakeEvent.clock += FakeEvent.tick
        self.t = FakeEvent.clock
        FakeEvent.order.append(self)

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _replay(phases, tick):
    """A replay of the phases' graph: the step's events recorded again."""
    phases.replays += 1
    FakeEvent.tick = tick
    for e in phases.events:
        e.record()


def _program(device_loop_steps=4):
    cfg = CFG
    opt = make_optimizer(cfg.training)
    rng = np.random.default_rng(0)
    n = device_loop_steps * cfg.training.batch_size
    ds = DeviceDataset(rng.integers(0, 50, n), rng.integers(0, 40, n),
                       cfg.training.batch_size, device="cpu")
    params = two_tower.init_params(torch.Generator().manual_seed(1), cfg.model, 50, 40)
    state = TrainState.for_config(params, opt, cfg)
    prog = make_epoch_fn(cfg, opt, ds.num_steps, num_items=40, device="cpu")
    return prog, state, ds


def test_step_phase_boundaries_are_reached_in_order():
    prog, state, ds = _program()
    assert prog._step.marks_phases
    phases = profiling.StepPhases(event=FakeEvent)
    FakeEvent.order = []
    prog.begin_epoch(state, ds.columns, 0)
    with phases.capturing():
        prog._body(*prog._args)
    assert FakeEvent.order == phases.events and phases.reached == 6
    assert phases.times_ms() == {}  # no replay yet
    _replay(phases, 1.0)
    profiling.register_phases(phases)
    assert profiling.snapshot()["phases_ms"] == {p: 1.0 for p in profiling.STEP_PHASES}
    with pytest.raises(RuntimeError, match="'forward' was due"):
        with phases.capturing():
            profiling.step_phase("gather")
            profiling.step_phase("backward")
    with pytest.raises(RuntimeError, match="marked 1 of its 6"):
        with phases.capturing():
            profiling.step_phase("gather")


def test_step_phases_cost_nothing_on_the_cpu(monkeypatch):
    monkeypatch.setattr(profiling.StepPhases, "boundary", _raise)
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    prog, state, ds = _program()
    assert prog._phases is None and prog.phase_ms() == {}
    prog(state, ds.columns, 0)  # an eager epoch passes every boundary
    records = []

    class Writer:
        def write(self, record, step):
            records.append(record)

    trainer = DeviceTrainer(CFG, num_items=40, writers=[Writer()], device="cpu")
    trainer.fit(trainer.init_state(50, 40), ds)
    assert records and not [k for k in records[0] if k.startswith("step/")]


def test_device_trainer_writes_the_last_replays_phases():
    _, _, ds = _program()
    records = []

    class Writer:
        def write(self, record, step):
            records.append(record)

    trainer = DeviceTrainer(CFG, num_items=40, writers=[Writer()], device="cpu")
    prog = trainer._epoch_fn(ds.num_steps)
    prog._phases = profiling.StepPhases(event=FakeEvent)
    _replay(prog._phases, 1.0)
    trainer.fit(trainer.init_state(50, 40), ds)
    assert {k: v for k, v in records[0].items() if k.startswith("step/")} == {
        f"step/{p}_ms": 1.0 for p in profiling.STEP_PHASES}


def test_the_phases_graph_replays_once_in_64_and_never_traced():
    prog, state, ds = _program()
    assert not prog._times_phases()  # no phases' graph on the CPU
    prog._timed = object()
    picks = []
    for replay in range(130):
        prog._replays = replay
        picks.append(prog._times_phases())
    assert [i for i, p in enumerate(picks) if p] == [0, 64, 128]
    with _profiler():
        assert not prog._times_phases()

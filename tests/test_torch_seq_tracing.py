"""The sequence tower's tracing (``utils/profiling.py``): the timed capture's
phases, which the tower marks on the way forward and on the gradient's way
back (``StepPhases(boundaries=None)``, summed by name), and nothing outside
a capture; the counter of routed slots per expert, read once by
``profiling.counters()`` and zeroed by ``reset()``; and the device loop's
epoch order of whole streams, which the step asks for."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from twotower_tpu_torch.data.sequences import StreamDataset
from twotower_tpu_torch.models import seq_tower
from twotower_tpu_torch.training.device_loop import make_epoch_fn
from twotower_tpu_torch.training.seq_step import COUNTER
from twotower_tpu_torch.training.state import TrainState, make_optimizer
from twotower_tpu_torch.utils import profiling

from test_torch_seq_tower import NUM_ITEMS, batch_of, config, params_for, streams


class Event:
    """A fake ``torch.cuda.Event``: each record advances a clock by 1 ms."""

    clock = 0.0

    def __init__(self):
        self.t = None

    def record(self, stream=None):
        Event.clock += 1.0
        self.t = Event.clock

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _program():
    cfg = config()
    opt = make_optimizer(cfg.training)
    rng = np.random.default_rng(0)
    data = StreamDataset(rng.integers(0, 40, 2000), rng.integers(0, NUM_ITEMS, 2000), cfg,
                         device="cpu")
    state = TrainState.for_config(params_for(cfg), opt, cfg)
    prog = make_epoch_fn(cfg, opt, data.num_steps, num_items=NUM_ITEMS, device="cpu")
    return prog, state, data


def test_the_step_marks_every_part_both_ways():
    prog, state, data = _program()
    assert prog._step.marks_phases and prog._step.phase_boundaries is None
    phases = profiling.StepPhases(event=Event, boundaries=None)
    prog.begin_epoch(state, data.columns, 0, torch.full((NUM_ITEMS,), -6.0))
    with phases.capturing():
        prog._body(*prog._args)
    names = phases.names
    assert names[0] == "gather" and names[-1] == "end"
    # forward: 3 layers' parts, then the head; backward: the loss, then each
    # block from the last, then the input projection; the optimizer; the rows
    forward = ["seq.attention", "seq.dense_ffn", "seq.attention", "seq.router", "seq.experts",
               "seq.shared", "seq.attention", "seq.router", "seq.experts", "seq.shared",
               "forward", "backward"]
    backward = ["seq.experts", "seq.attention", "seq.experts", "seq.attention",
                "seq.dense_ffn", "seq.attention", "backward", "optimizer", "rows", "end"]
    assert names[1:] == forward + backward
    phases.replays = 1
    for e in phases.events:
        e.record()
    ms = phases.times_ms()
    assert ms["seq.attention"] == 6.0 and ms["seq.experts"] == 4.0 and ms["backward"] == 2.0
    assert sum(ms.values()) == len(names) - 1


def test_fixed_phases_still_refuse_another_order():
    phases = profiling.StepPhases(event=Event)
    with pytest.raises(RuntimeError, match="'forward' was due"):
        with phases.capturing():
            profiling.step_phase("gather")
            profiling.step_phase("seq.attention")
    free = profiling.StepPhases(event=Event, boundaries=None)
    with pytest.raises(RuntimeError, match="from 'gather' to 'end'"):
        with free.capturing():
            profiling.step_phase("gather")


def test_the_eager_forward_marks_and_records_nothing():
    cfg = config()
    params, b = params_for(cfg), batch_of(streams(), 0)
    rows = params["item_embedding"][b["hist_idx"].long()]
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        seq_tower.forward_stream(params, rows, b["pos"], b["weight"], cfg.model)
    assert profiling.capturing_phases() is None
    assert [r for r in profiling.snapshot()["records"] if r.name.startswith("seq.")] == []


def test_the_loop_permutes_whole_streams_as_the_step_asks():
    prog, state, data = _program()
    assert prog._step.permutes_streams and prog.num_steps > 2
    b = prog.batch_size
    for epoch in (0, 1):
        prog.begin_epoch(state, data.columns, epoch, torch.full((NUM_ITEMS,), -6.0))
        perm = prog._perm.view(prog.num_steps, b).cpu()
        starts = perm[:, 0]
        assert torch.equal(perm, starts[:, None] + torch.arange(b)[None, :])
        assert sorted((starts // b).tolist()) == list(range(prog.num_steps))


def test_the_counter_counts_routed_slots_and_resets():
    prog, state, data = _program()
    profiling.reset()
    prog(state, data.columns, 0, torch.full((NUM_ITEMS,), -6.0))
    counts = profiling.counters()[COUNTER]
    real = int(data.columns["weight"].sum())
    assert len(counts) == 2 and [sum(layer) for layer in counts] == [2 * real] * 2
    profiling.reset()
    assert profiling.counters()[COUNTER] == [[0.0] * 8] * 2

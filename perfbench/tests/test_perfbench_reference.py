"""The reference against the program at a tiny size on the CPU: a whole run
of each cell (set-up, window, check), which must come out correct with
every number far below its limit; and the trace reduction on made-up
events."""

import json
from types import SimpleNamespace

import pytest
import torch

from perfbench.harness.manifest import load_cell
from perfbench.harness.runner import run_cell
from perfbench.harness.trace import WINDOW, idle_gaps, summarize, union_length
from perfbench.tests.tiny import tiny_root

CELLS = ["c3_train", "c3_validate", "c3_eval_exact", "c4_serve"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_on_the_cpu_is_correct(root, workload):
    cell = load_cell(root, workload)
    line = run_cell(cell, 2**31 + 77, 0.5, False, "cpu", log=lambda m: None)
    assert line["correct"], json.dumps(line["compared"])
    assert line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["compared"].items():
        assert c["value"] <= c["limit"] / 10 or c["value"] == 0.0, name
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert list(line)[-1] == "compared"


def test_same_seed_same_inputs(root):
    from perfbench.harness import weights as wt

    model = {"embedding_dim": 16, "user_tower_dims": [32, 16], "item_tower_dims": [32, 16]}
    a = wt.make_params({"kind": "planted", "clusters": 8, "noise": 0.5}, 5, 100, 50, model, "cpu")
    b = wt.make_params({"kind": "planted", "clusters": 8, "noise": 0.5}, 5, 100, 50, model, "cpu")
    assert torch.equal(a["user_embedding"], b["user_embedding"])
    assert a["user_embedding"].shape == (128, 16) and a["item_embedding"].shape == (128, 16)
    assert torch.equal(a["user_tower"][0]["kernel"], a["item_tower"][0]["kernel"])


def _event(name, start, end, device=False, annotation=False, device_total=0.0):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end), is_async=False,
        device_type=torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU,
        is_user_annotation=annotation, device_time_total=device_total)


def test_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40)]
    assert union_length(spans, 0, 50) == 30
    assert union_length(spans, 8, 35) == 17
    assert idle_gaps(spans, 0, 50) == [(20, 30), (40, 50)]


def test_trace_reduction():
    events = [
        _event(WINDOW, 0, 1000),
        _event("perfbench.search", 100, 400, annotation=True, device_total=250.0),
        _event("aten::mm", 110, 120),
        _event("cudaGraphLaunch", 500, 520),
        _event("kernel_a", 150, 350, device=True),
        _event("kernel_b", 350, 400, device=True),
        _event("kernel_a", 600, 700, device=True),
        _event("perfbench.search", 150, 400, device=True, annotation=True),
    ]
    trace = summarize(events)
    assert trace.window_s == pytest.approx(1e-3)
    assert trace.busy_s == pytest.approx(350e-6)
    assert trace.idle_pct == pytest.approx(65.0)
    assert trace.device_ops["kernel_a"] == pytest.approx([300e-6, 2])
    assert trace.device_s("kernel") == pytest.approx((350e-6, 3))
    assert trace.spans["search"] == pytest.approx([250e-6, 1])
    gaps = trace.breakdown()["idle_gaps"]
    assert sum(s for _, s in gaps) == pytest.approx(650e-6)
    assert ["host: cudaGraphLaunch", pytest.approx(200e-6)] in gaps

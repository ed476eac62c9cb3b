"""Operation and byte counts of the roofline shares and the MFU FLOPs, at
the cells' shapes."""

import json
from pathlib import Path

import pytest

from perfbench.harness import peaks
from perfbench.harness.manifest import load_module

BENCH = Path(__file__).resolve().parents[1]
C3 = json.loads((BENCH / "configs" / "lifecycle_50m_1chip.json").read_text())


def metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def test_step_mfu_flops_per_example():
    # towers: 3 products a layer, 2 FLOPs a MAC, 229,376 MACs a tower; the
    # loss: S, dU and dV at 2 B D each.
    flops = metric("step_mfu").flops_per_example(C3["port"]["model"], 8192)
    assert flops == 3 * 2 * 2 * (128 * 512 + 512 * 256 + 256 * 128) + 6 * 8192 * 128
    assert flops == 9_043_968


def test_step_mfu_reads_the_rate():
    class Ctx:
        config, traffic, layer, trace = C3, {}, {}, None
        e2e = {"train_examples_per_s": 2.0e6}

    value = metric("step_mfu").read(Ctx)
    assert value == pytest.approx(100 * 9_043_968 * 2.0e6 / 989e12)


@pytest.mark.parametrize("name, flops, bound_ms", [
    ("loss_fwd_roofline", 2 * 8192 ** 2 * 128, 0.1041204),
    ("loss_bwd_roofline", 4 * 8192 ** 2 * 128, 0.2082408),
])
def test_loss_kernel_work(name, flops, bound_ms):
    f, nbytes = metric(name).work(8192, 128)
    assert f == flops
    assert nbytes < 10 * 8192 * 128 * 4  # bounded by operations, far from the bytes
    assert peaks.bound_s(f, nbytes, peaks.F32_ACCURATE_FLOPS) * 1e3 == pytest.approx(bound_ms,
                                                                                    rel=1e-5)


@pytest.mark.parametrize("name, peak, corpus_bytes, bound_ms", [
    ("search_approx_roofline", peaks.BF16_FLOPS, 2, 1.21414),
    ("search_twopass_roofline", peaks.F32_ACCURATE_FLOPS, 4, 7.27750),
])
def test_search_work(name, peak, corpus_bytes, bound_ms):
    f, nbytes = metric(name).work(4096, 1_145_145, 128, 100)
    assert f == 2 * 4096 * 1_145_145 * 128
    assert nbytes == 1_145_145 * 128 * corpus_bytes + 4096 * 128 * 4 + 4096 * 100 * 12
    assert peaks.bound_s(f, nbytes, peak) * 1e3 == pytest.approx(bound_ms, rel=1e-4)


def test_roofline_share_from_a_trace():
    from perfbench.harness.trace import Trace

    trace = Trace(window_s=1.0, busy_s=0.9,
                  device_ops={"fused_loss_fwd_kernel": [0.002, 10],
                              "fused_loss_fwd_merge_slices": [0.0005, 10],
                              "fused_loss_bwd_du_kernel": [0.005, 10]})

    class Ctx:
        config, traffic, e2e = C3, {}, {}
        layer = {"traced_steps": 10}

    Ctx.trace = trace
    share = metric("loss_fwd_roofline").read(Ctx)
    assert share == pytest.approx(100 * 10 * 0.1041204e-3 / 0.0025, rel=1e-4)
    Ctx.trace = Trace(window_s=1.0, busy_s=0.9)
    assert metric("loss_fwd_roofline").read(Ctx) is None  # nothing to read: left out


def test_eval_mfu_counts_the_encode_once_a_call():
    m = metric("eval_mfu")
    model = C3["port"]["model"]
    per_row = m.flops_per_row(model, 1_145_145, 500_000)
    tower = 2 * (128 * 512 + 512 * 256 + 256 * 128)
    assert per_row == pytest.approx(1_145_145 * tower / 500_000 + tower + 2 * 1_145_145 * 128)

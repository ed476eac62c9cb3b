"""``seq_attention_roofline``: the sequence tower's block attention against
its roofline, its work counted at the cell's shape and its share read from
traces made by hand."""

import json
from pathlib import Path

import pytest

from perfbench.harness import peaks
from perfbench.harness.manifest import load_module
from perfbench.harness.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
SEQ = json.loads((BENCH / "configs" / "seq_dsv2lite_1chip.json").read_text())


def reader():
    return load_module(BENCH / "metrics" / "seq_attention_roofline.py",
                       "t_seq_attention_roofline")


def test_seq_attention_work():
    # A layer at 32,768 slots, 16 heads of q 128 + 64, v 128, one k_pe of 64:
    # the forward reads q, k_nope, k_pe, v and writes O (bf16) and lse
    # (float32); the backward reads those inputs, O, dO and lse and writes
    # their gradients. Products over the 2 x 64 keys of a query's two blocks.
    flops, nbytes = reader().work(SEQ["port"]["model"], 32768)
    inputs = 32768 * (16 * 192 + 16 * 128 + 64 + 16 * 128)
    forward = 2 * inputs + 2 * 32768 * 16 * 128 + 4 * 32768 * 16
    backward = 2 * inputs + 2 * 2 * 32768 * 16 * 128 + 4 * 32768 * 16 + 2 * inputs
    assert (forward, backward) == (610_271_232, 1_218_445_312)
    assert nbytes == 5 * (forward + backward)
    assert flops == 5 * 2 * 32768 * 16 * 128 * ((128 + 64 + 128) + (2 * 128 + 2 * 192))
    # bound by the bytes: 2.73 ms a step against 0.65 ms of products
    assert peaks.bound_s(flops, nbytes, peaks.BF16_FLOPS) * 1e3 == pytest.approx(2.729428,
                                                                                 rel=1e-6)


def test_seq_attention_share_from_a_trace():
    kernels = {
        "void (anonymous namespace)::stream_attention_fwd_kernel<64, 128, 64, 128>(Args)":
            [0.004, 20],
        "void (anonymous namespace)::stream_attention_dq_kernel<64, 128, 64, 128>(Args)":
            [0.003, 10],
        "void (anonymous namespace)::stream_attention_dkv_kernel<64, 128, 64, 128>(Args)":
            [0.003, 10],
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN": [0.5, 100],  # not the attention's
    }

    class Ctx:
        config, traffic, e2e = SEQ, {}, {}
        layer = {"traced_steps": 2}
        trace = Trace(window_s=1.0, busy_s=0.9, device_ops=kernels)

    share = reader().read(Ctx)
    assert share == pytest.approx(100 * 2 * 2.729428e-3 / 0.010, rel=1e-6)
    Ctx.trace = Trace(window_s=1.0, busy_s=0.9, device_ops={"nvjet_tst": [0.5, 100]})
    assert reader().read(Ctx) is None  # no attention kernels: nothing to read

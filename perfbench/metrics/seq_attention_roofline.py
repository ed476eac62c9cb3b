"""The sequence tower's block attention (``ops/attention.py``: the forward,
dQ and dK/dV kernels, by the profiler's kernel names) against its roofline,
over the traced window's steps. The device time is every launch of the
kernels, the forward run again by recomputation included; the work the
step needs is each layer's forward once and its backward, the larger of
the products at the dense bfloat16 peak and the bytes at the HBM bandwidth.

Work a layer, ``S`` slots, ``h`` heads, ``W`` the window (a query's keys lie
in its block of ``W`` slots and the one before: ``2 W`` keys): the forward's
products ``2 S h 2W (dn + dr + dv)`` (``Q K^T``, ``P V``), the backward's
``2 S h 2W (2 dv + 2 (dn + dr))`` (``dP``, ``dV``, ``dQ``, ``dK``; ``S``
itself is the forward's work, whatever a kernel recomputes). Bytes, all
bfloat16 but ``lse`` (float32): the forward reads q, k_nope, k_pe and v and
writes O and ``lse``; the backward reads q, k_nope, k_pe, v, O, dO and
``lse`` and writes dq, dk_nope, dk_pe and dv."""

from perfbench.harness.peaks import BF16_FLOPS, bound_s


def work(model: dict, slots: int) -> tuple[int, int]:
    s = model["sequence"]
    h, w = s["num_attention_heads"], s["max_window"]
    dn, dr, dv = s["qk_nope_head_dim"], s["qk_rope_head_dim"], s["v_head_dim"]
    keys = 2 * w
    flops = 2 * slots * h * keys * ((dn + dr + dv) + (2 * dv + 2 * (dn + dr)))
    inputs = slots * (h * (dn + dr) + h * dn + dr + h * dv)  # q, k_nope, k_pe, v
    lse = 4 * slots * h
    forward = 2 * inputs + 2 * slots * h * dv + lse
    backward = 2 * inputs + 2 * 2 * slots * h * dv + lse + 2 * inputs
    return s["num_hidden_layers"] * flops, s["num_hidden_layers"] * (forward + backward)


def read(ctx):
    seconds, count = ctx.trace.device_s("stream_attention_")
    steps = ctx.layer.get("traced_steps", 0)
    if not count or not steps:
        return None
    port = ctx.config["port"]
    flops, nbytes = work(port["model"], port["training"]["batch_size"])
    return 100.0 * steps * bound_s(flops, nbytes, BF16_FLOPS) / seconds

"""The fused loss's backward (``ops/kernels.py``: the dU and dV kernels and
their slice sums, by the profiler's kernel names) against its roofline, over
the traced window's steps. The work the backward needs at these shapes: the
gradient products dU = dS V and dV = dS^T U, 4 B^2 D operations at float32
accuracy (the faster of 67 TFLOP/s and 495/3 TFLOP/s); S itself is the
forward's work, whatever a kernel recomputes. Its bytes: U and V, the
item ids, log q, weights, each row's log-sum-exp and the upstream gradient
read once; dU and dV written once (float32)."""

from perfbench.harness.peaks import F32_ACCURATE_FLOPS, bound_s


def work(batch: int, dim: int) -> tuple[int, int]:
    return 4 * batch * batch * dim, 4 * batch * dim * 4 + 5 * batch * 4


def read(ctx):
    seconds, count = ctx.trace.device_s("fused_loss_bwd")
    steps = ctx.layer.get("traced_steps", 0)
    if not count or not steps:
        return None
    port = ctx.config["port"]
    flops, nbytes = work(port["training"]["batch_size"], port["model"]["user_tower_dims"][-1])
    return 100.0 * steps * bound_s(flops, nbytes, F32_ACCURATE_FLOPS) / seconds

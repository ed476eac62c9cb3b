"""The fused loss's forward (``ops/kernels.py``: the forward kernel and its
merge pass, by the profiler's kernel names) against its roofline, over the
traced window's steps. The work the forward needs at these shapes: the
scores S = U V^T, 2 B^2 D operations, at float32 accuracy (the faster of
67 TFLOP/s on the float32 units and 495/3 TFLOP/s as three TF32 passes);
its bytes: U and V read once (float32), the item ids, log q and weights
(4 bytes a row each) read once, each row's log-sum-exp and positive logit
(float32) written once."""

from perfbench.harness.peaks import F32_ACCURATE_FLOPS, bound_s


def work(batch: int, dim: int) -> tuple[int, int]:
    return 2 * batch * batch * dim, 2 * batch * dim * 4 + 3 * batch * 4 + 2 * batch * 4


def read(ctx):
    seconds, count = ctx.trace.device_s("fused_loss_fwd")
    steps = ctx.layer.get("traced_steps", 0)
    if not count or not steps:
        return None
    port = ctx.config["port"]
    flops, nbytes = work(port["training"]["batch_size"], port["model"]["user_tower_dims"][-1])
    return 100.0 * steps * bound_s(flops, nbytes, F32_ACCURATE_FLOPS) / seconds

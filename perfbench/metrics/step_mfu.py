"""The train step's model FLOPs as a share of the card's dense bfloat16 peak
(the configuration's compute dtype): FLOPs an example from the shapes, times
the window's examples a second. Counted once each: both towers forward and
backward (three products a layer: forward, input gradient, weight
gradient), the loss's scores S = U V^T and its two gradient products dU and
dV; the S that the backward recomputes is not counted."""

from perfbench.harness.peaks import BF16_FLOPS


def tower_macs(in_dim: int, dims) -> int:
    macs = 0
    for out in dims:
        macs += in_dim * out
        in_dim = out
    return macs


def flops_per_example(model: dict, batch: int) -> int:
    e = model["embedding_dim"]
    towers = 3 * 2 * (tower_macs(e, model["user_tower_dims"])
                      + tower_macs(e, model["item_tower_dims"]))
    d = model["user_tower_dims"][-1]
    return towers + 3 * 2 * batch * d


def read(ctx):
    rate = ctx.e2e.get("train_examples_per_s")
    if not rate:
        return None
    port = ctx.config["port"]
    return 100.0 * flops_per_example(port["model"], port["training"]["batch_size"]) * rate / BF16_FLOPS

"""The routed and shared experts of every MoE layer against their roofline,
a step at a time: the least time their forward and backward work takes
(the products at the dense bfloat16 peak, or the bytes at the HBM
bandwidth, the larger) over the device time the captured step spends on
them (the phases ``seq.experts`` and ``seq.shared`` of the program's timed
replay, ``utils/profiling.py::StepPhases``: the routed and shared experts'
forward, and each MoE block's whole backward, its forward run again by
recomputation included), so that it reads the same work whatever
implements it.

Work a step, per MoE layer, ``T`` slots: the routed experts' three
products for ``K`` experts a slot and the shared experts' for every slot,
``2 T (K + S) 3 H I`` operations forward and twice that backward; bytes: the
experts' bfloat16 weights read forward, read again and their float32
gradients written backward, and each expert product's bfloat16 input and
output read or written once forward and twice backward."""

from perfbench.harness.peaks import BF16_FLOPS, bound_s
from perfbench.harness.spans import phase_ms


def work(model: dict, slots: int) -> tuple[float, float]:
    s = model["sequence"]
    h, i = s["hidden_size"], s["moe_intermediate_size"]
    k, shared, n = s["num_experts_per_tok"], s["n_shared_experts"], s["n_routed_experts"]
    layers = s["num_hidden_layers"] - s["first_k_dense_replace"]
    flops = 3 * 2 * slots * (k + shared) * 3 * h * i * layers
    weights = 3 * h * i * (n + shared)
    acts = slots * (k + shared) * (h + 2 * i + i + h)  # in, gate|up, act, out
    nbytes = layers * (weights * (2 + 2 + 4) + 3 * 2 * acts)
    return flops, nbytes


def read(ctx):
    experts, shared = phase_ms("seq.experts"), phase_ms("seq.shared")
    if experts is None:
        return None
    seconds = (experts + (shared or 0.0)) / 1000.0
    port = ctx.config["port"]
    flops, nbytes = work(port["model"], port["training"]["batch_size"])
    return 100.0 * bound_s(flops, nbytes, BF16_FLOPS) / seconds

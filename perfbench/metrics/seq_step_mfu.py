"""The sequence tower's train step's model FLOPs as a share of the card's
dense bfloat16 peak (the configuration's compute dtype): FLOPs an example
(a slot with a target) from the widths, times the window's examples a
second. Counted once each, forward and backward (three products a weight:
forward, input gradient, weight gradient): 6 times the tower's parameters
one slot reads (the input and output projections, every layer's attention,
the dense layer's feed-forward, and in each MoE layer the router, the
``num_experts_per_tok`` routed experts and the shared ones); attention's
scores and weighted values over each slot's context (its place in its
window plus one, averaged over the traffic's length law, the streams' cut
windows left out); the item tower and the loss as ``step_mfu.py`` counts
them. The forward that recomputation runs again is not counted."""

from perfbench.harness.peaks import BF16_FLOPS


def active_params(s: dict, embedding_dim: int, out_dim: int) -> int:
    """The tower's parameters one slot reads (norm weights left out)."""
    h, nh = s["hidden_size"], s["num_attention_heads"]
    dn, dr, dv, r = s["qk_nope_head_dim"], s["qk_rope_head_dim"], s["v_head_dim"], s["kv_lora_rank"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) + nh * dv * h
    dense = 3 * h * s["intermediate_size"]
    i = s["moe_intermediate_size"]
    moe = s["n_routed_experts"] * h + 3 * h * i * (s["num_experts_per_tok"] + s["n_shared_experts"])
    k = s["first_k_dense_replace"]
    return (embedding_dim * h + h * out_dim + s["num_hidden_layers"] * attn + k * dense
            + (s["num_hidden_layers"] - k) * moe)


def total_params(s: dict, embedding_dim: int, out_dim: int) -> int:
    """Every parameter of the tower (norm weights included)."""
    h, nh = s["hidden_size"], s["num_attention_heads"]
    dn, dr, dv, r = s["qk_nope_head_dim"], s["qk_rope_head_dim"], s["v_head_dim"], s["kv_lora_rank"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r + r * nh * (dn + dv) + nh * dv * h + 2 * h
    dense = 3 * h * s["intermediate_size"]
    i, n = s["moe_intermediate_size"], s["n_routed_experts"]
    moe = n * h + 3 * h * i * (n + s["n_shared_experts"])
    k = s["first_k_dense_replace"]
    return (embedding_dim * h + h + h * out_dim + k * (attn + dense)
            + (s["num_hidden_layers"] - k) * (attn + moe))


def mean_context(window: dict) -> float:
    """A slot's keys on average: ``E[L (L + 1) / 2] / E[L]`` under the
    length law (Zipf over ``[min, max]``)."""
    lengths = range(int(window["min"]), int(window["max"]) + 1)
    p = [n ** -float(window["exponent"]) for n in lengths]
    slots = sum(w * n for w, n in zip(p, lengths))
    keys = sum(w * n * (n + 1) / 2 for w, n in zip(p, lengths))
    return keys / slots


def flops_per_example(model: dict, batch: int, window: dict) -> float:
    s = model["sequence"]
    e, d = model["embedding_dim"], model["item_tower_dims"][-1]
    tower = 6 * active_params(s, e, d)
    qk = s["qk_nope_head_dim"] + s["qk_rope_head_dim"]
    attention = 3 * 2 * s["num_attention_heads"] * (qk + s["v_head_dim"]) * mean_context(window)
    macs, d_in = 0, e
    for out in model["item_tower_dims"]:
        macs += d_in * out
        d_in = out
    return tower + s["num_hidden_layers"] * attention + 3 * 2 * macs + 3 * 2 * batch * d


def read(ctx):
    rate = ctx.e2e.get("train_examples_per_s")
    if not rate:
        return None
    port = ctx.config["port"]
    flops = flops_per_example(port["model"], port["training"]["batch_size"], ctx.traffic["window"])
    return 100.0 * flops * rate / BF16_FLOPS

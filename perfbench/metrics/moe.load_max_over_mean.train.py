"""The routed load's imbalance: in the worst MoE layer, the slots routed to
its busiest expert over the mean of its experts, over the traced window's
steps (the program's counter ``moe.routed_tokens``, ``[L_moe, N]``, added
into on the device by every step and read once after the window)."""


def read(ctx):
    try:
        from twotower_tpu_torch.utils import profiling
    except ImportError:
        return None
    counters = getattr(profiling, "counters", None)
    counts = None if counters is None else counters().get("moe.routed_tokens")
    if not counts or not any(sum(layer) for layer in counts):
        return None
    return max(max(layer) / (sum(layer) / len(layer)) for layer in counts if sum(layer))

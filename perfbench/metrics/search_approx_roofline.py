"""The approx search (``ops/topk.py::topk_mips_approx`` over a bfloat16
corpus) against its roofline: the device time of the kernels launched inside
its calls in the traced evaluation, against the least time of those calls.
A call of ``b`` query rows over ``N`` corpus rows of depth ``D`` needs
2 b N D operations at the bfloat16 dense peak, and reads the corpus (2 bytes
an element) and the queries (float32) once and writes its [b, k] scores
(float32) and ids (int64) once."""

from perfbench.harness.peaks import BF16_FLOPS, bound_s


def work(rows: int, items: int, dim: int, k: int) -> tuple[int, int]:
    return 2 * rows * items * dim, items * dim * 2 + rows * dim * 4 + rows * k * 12


def read(ctx):
    seconds, calls = ctx.trace.spans.get("search", (0.0, 0))
    batches = ctx.layer.get("search_batches") or []
    if not calls or seconds <= 0 or not batches:
        return None
    port = ctx.config["port"]
    items, dim = ctx.config["num_items"], port["model"]["user_tower_dims"][-1]
    k = max(port["retrieval"]["top_k_eval"])
    least = sum(bound_s(*work(b, items, dim, k), BF16_FLOPS) for b in batches)
    return 100.0 * least / seconds

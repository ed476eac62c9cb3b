"""A whole evaluation call's model FLOPs as a share of the card's peak at
the search's precision (bfloat16's dense peak for a bfloat16 corpus, the
float32-accurate rate for a float32 one): the corpus encode (every item
through the item tower, forward), and for each row the user tower and its
scores against every item (2 N D), over the call's rows, times the window's
rows a second."""

from perfbench.harness.peaks import FLOPS_BY_DTYPE


def tower_macs(in_dim: int, dims) -> int:
    macs = 0
    for out in dims:
        macs += in_dim * out
        in_dim = out
    return macs


def flops_per_row(model: dict, items: int, rows: int) -> float:
    e = model["embedding_dim"]
    encode = 2 * items * tower_macs(e, model["item_tower_dims"])
    per_row = 2 * tower_macs(e, model["user_tower_dims"]) + 2 * items * model["user_tower_dims"][-1]
    return encode / rows + per_row


def read(ctx):
    rate = ctx.e2e.get("eval_rows_per_s")
    if not rate:
        return None
    model = ctx.config["port"]["model"]
    peak = FLOPS_BY_DTYPE[ctx.layer["search_dtype"]]
    return 100.0 * flops_per_row(model, ctx.config["num_items"], int(ctx.traffic["rows"])) \
        * rate / peak

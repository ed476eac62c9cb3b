"""Plain reference of evaluation and serving: the towers in eval mode (no
dropout), the corpus encode, the scores at a stated precision, ranks, the
top-k and the retrieval metrics. Blocks of rows keep its memory bounded.

Precisions of a score ``q . c`` (queries and corpus rows, float32 in):

- ``float32``: float32 products, TF32 off.
- ``tf32``: both operands rounded to TF32 first (the control of float32).
- ``bfloat16``: both operands rounded to bfloat16, summed in float32.
- ``fp8``: both rounded to float8 e4m3 (the control of bfloat16).
- ``int8`` / ``int4``: symmetric quantisation, the corpus by one scale
  (max |x| / 127, or / 7), each query by its own row's; rounding half to
  even, clipped; integer scores (exact in float32 at these depths) times
  both scales. ``int4`` is the control of ``int8``.

Metrics under the one-positive protocol, from the rank of the held-out item
(the number of items scoring strictly above it): recall@k = rank < k;
ndcg@k = 1 / log2(rank + 2) where rank < k; mrr = 1 / (rank + 1) where the
rank is below the largest k, else 0; each averaged over the rows.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.train_ref import no_tf32, tf32_round, tower

QUANT_LEVELS = {"int8": 127.0, "int4": 7.0}


def encode(layers, rows: torch.Tensor, dtype: torch.dtype, block: int = 1 << 20) -> torch.Tensor:
    """Rows through a tower in eval mode, normalised, in blocks."""
    with torch.no_grad(), no_tf32():
        return torch.cat([tower(layers, rows[lo:lo + block], dtype=dtype, rate=0.0, gen=None)
                          for lo in range(0, rows.shape[0], block)])


def _quantize(x: torch.Tensor, levels: float, per_row: bool):
    if per_row:
        absmax = torch.maximum(x.amax(dim=1), -x.amin(dim=1))
    else:
        absmax = torch.maximum(x.amax(), -x.amin())
    scale = absmax / levels
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30), torch.zeros_like(scale))
    q = (x * (inv[:, None] if per_row else inv)).round().clamp(-levels, levels)
    return q, scale


class Scorer:
    """Scores of queries against a corpus at one precision."""

    def __init__(self, corpus: torch.Tensor, precision: str):
        self.precision = precision
        if precision in QUANT_LEVELS:
            self.corpus, self.scale = _quantize(corpus.float(), QUANT_LEVELS[precision], False)
        else:
            self.corpus, self.scale = self._operand(corpus), None

    def _operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.precision == "tf32":
            return tf32_round(x)
        if self.precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        if self.precision == "fp8":
            return x.to(torch.float8_e4m3fn).float()
        return x

    def queries(self, q: torch.Tensor):
        if self.precision in QUANT_LEVELS:
            return _quantize(q.float(), QUANT_LEVELS[self.precision], True)
        return self._operand(q), None

    def scores(self, queries, lo: int = 0, hi: int | None = None, ids=None) -> torch.Tensor:
        """``[B, C]`` scores of prepared ``queries`` against corpus rows
        ``[lo, hi)``, or, with ``ids`` ``[B, K]``, ``[B, K]`` scores of each
        query against its own rows."""
        q, q_scale = queries
        with torch.no_grad(), no_tf32():
            if ids is not None:
                s = torch.einsum("bd,bkd->bk", q, self.corpus[ids])
            else:
                s = q @ self.corpus[lo:hi].T
        if q_scale is not None:
            s = s * q_scale[:, None] * self.scale
        return s


def topk(scorer: Scorer, q: torch.Tensor, k: int, block: int = 1 << 20, ids: bool = False):
    """The exact top-``k`` scores ``[B, k]`` (descending) over the corpus;
    with ``ids``, ``(scores, ids)``."""
    prepared = scorer.queries(q)
    best = best_ids = None
    n = scorer.corpus.shape[0]
    for lo in range(0, n, block):
        s = scorer.scores(prepared, lo, min(n, lo + block))
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + lo
        if best is not None:
            v, sel = torch.topk(torch.cat([best, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_ids, i], 1), 1, sel)
        best, best_ids = v, i
    return (best, best_ids) if ids else best


def ranks(scorer: Scorer, q: torch.Tensor, true_items: torch.Tensor,
          block: int = 1 << 20) -> torch.Tensor:
    """Items scoring strictly above each row's held-out item. The held-out
    item's own score is taken once more from the block product, where it may
    differ by a rounding from the row product: it never counts against
    itself."""
    prepared = scorer.queries(q)
    own = scorer.scores(prepared, ids=true_items[:, None])
    rank = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)
    n = scorer.corpus.shape[0]
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        s = scorer.scores(prepared, lo, hi)
        rank += (s > own).sum(dim=1)
        rows = ((true_items >= lo) & (true_items < hi)).nonzero().squeeze(1)
        rank[rows] -= (s[rows, true_items[rows] - lo] > own[rows, 0]).long()
    return rank


def metric_sums(rank: torch.Tensor, ks) -> dict[str, float]:
    """Sums over the rows (divide by the row count for the means)."""
    ks = sorted(ks)
    r = rank.double()
    out = {}
    for k in ks:
        hit = rank < k
        out[f"recall@{k}"] = float(hit.double().sum())
        out[f"ndcg@{k}"] = float((hit.double() / torch.log2(r + 2.0)).sum())
    out["mrr"] = float(((rank < ks[-1]).double() / (r + 1.0)).sum())
    return out


def served_gap(scorer: Scorer, q: torch.Tensor, served: torch.Tensor, k: int) -> dict:
    """How far the served top-``k`` ids ``[B, k]`` fall short of the exact
    top-``k`` at this precision: the widest gap by which a served id's score
    lies below the ``k``-th best, and the rows whose ids are not ``k``
    distinct ids of the corpus."""
    n = scorer.corpus.shape[0]
    bad = ((served < 0) | (served >= n)).any(dim=1)
    bad |= torch.sort(served, dim=1).values.diff(dim=1).eq(0).any(dim=1)
    ids = served.clamp(0, n - 1)
    kth = topk(scorer, q, k)[:, -1]
    own = scorer.scores(scorer.queries(q), ids=ids)
    gap = torch.clamp(kth[:, None] - own, min=0.0).amax(dim=1)
    return {"gap": float(gap.max()) if len(gap) else 0.0, "bad_rows": int(bad.sum()),
            "scores": own}


def gap_of_metrics(program: dict, reference_sums: dict, rows: int) -> float:
    """Widest gap between the program's metric means and the reference's."""
    missing = set(reference_sums) - set(program)
    if missing:
        return math.inf
    return max(abs(program[k] - reference_sums[k] / rows) for k in reference_sums)

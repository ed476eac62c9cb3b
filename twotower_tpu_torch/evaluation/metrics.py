"""Retrieval metrics: Recall@K, NDCG@K and MRR (PyTorch).

Counterpart of ``twotower_tpu/evaluation/metrics.py``: computed on the
device from top-k index lists under the single-positive protocol (each eval
row holds one held-out item), where NDCG@K reduces to 1/log2(rank+2).
"""

from __future__ import annotations

import torch


def rank_of_true_item(topk_idx: torch.Tensor, true_item: torch.Tensor) -> torch.Tensor:
    """Position (0-based) of the true item in each top-k list; ``k`` if absent.

    Args:
      topk_idx: ``[B, k]`` retrieved item ids, best first.
      true_item: ``[B]`` held-out positive ids.
    """
    k = topk_idx.shape[1]
    hits = topk_idx == true_item[:, None].to(topk_idx.dtype)
    pos = torch.argmax(hits.to(torch.int8), dim=1)  # the first hit
    return torch.where(hits.any(dim=1), pos, torch.full_like(pos, k))


def metrics_at_k(
    topk_idx: torch.Tensor,
    true_item: torch.Tensor,
    ks: tuple[int, ...],
    *,
    weights: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Recall@K and NDCG@K for every K in ``ks`` from one ``[B, max_k]``
    retrieval, plus MRR; scalars averaged over (weighted) rows."""
    if max(ks) > topk_idx.shape[1]:
        raise ValueError(f"max k {max(ks)} exceeds retrieved {topk_idx.shape[1]}")
    rank = rank_of_true_item(topk_idx, true_item)
    if weights is None:
        weights = torch.ones(rank.shape, dtype=torch.float32, device=rank.device)
    weights = weights.float()
    denom = torch.clamp(weights.sum(), min=1.0)
    rank_f = rank.float()
    gain = 1.0 / torch.log2(rank_f + 2.0)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        hit = (rank < k).float()
        out[f"recall@{k}"] = (hit * weights).sum() / denom
        out[f"ndcg@{k}"] = (hit * gain * weights).sum() / denom
    out["mrr"] = (
        (rank < topk_idx.shape[1]).float() / (rank_f + 1.0) * weights
    ).sum() / denom
    return out


def merge_metric_sums(
    batch_metrics: list[dict], batch_weights: list[float]
) -> dict[str, float]:
    """Weighted average of per-batch scalar metrics on the host."""
    if not batch_metrics:
        return {}
    total = sum(batch_weights)
    out: dict[str, float] = {}
    for key in batch_metrics[0]:
        out[key] = float(
            sum(float(m[key]) * w for m, w in zip(batch_metrics, batch_weights))
            / max(total, 1e-12)
        )
    return out

"""Retrieval losses: in-batch sampled softmax with log-Q correction (PyTorch).

Counterpart of ``twotower_tpu/ops/losses.py`` (in-batch part). This module
is the plain version of the fused loss in ``ops/kernels.py``: the CPU path,
and the reference the CUDA kernels are held against.

Math (Yi et al. 2019, "Sampling-Bias-Corrected Neural Modeling"):
    s_ij   = <u_i, v_j> / temperature
    s'_ij  = s_ij - log q(item_j)          (log-Q correction, all columns)
    mask   s'_ij = -1e9  where item_j == item_i, j != i  (accidental hits)
    loss   = -sum_i w_i * log softmax(s'_i)_i / max(sum_i w_i, 1)
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # finite sentinel: keeps grads zero without NaN propagation


def _in_batch_logits(
    user_emb: torch.Tensor,
    item_emb_all: torch.Tensor,
    item_idx_all: torch.Tensor,
    row_offset: int,
    *,
    temperature: float,
    log_q: torch.Tensor | None,
    weights_all: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked, tempered, log-Q-corrected ``[R, B]`` logits. Returns
    ``(logits, diag, scores)``."""
    rows = user_emb.shape[0]
    batch = item_emb_all.shape[0]
    dev = user_emb.device
    # float32 accumulation whatever the input dtype.
    scores = user_emb.float() @ item_emb_all.float().T
    logits = scores / temperature
    if log_q is not None:
        logits = logits - log_q[item_idx_all].float()[None, :]
    col_ids = torch.arange(batch, device=dev)[None, :]
    row_ids = row_offset + torch.arange(rows, device=dev)[:, None]
    diag = col_ids == row_ids
    row_item = item_idx_all[row_offset : row_offset + rows]
    mask = item_idx_all[None, :] == row_item[:, None]
    if weights_all is not None:
        # Zero-weight (padding) columns must not serve as negatives.
        mask = mask | (weights_all[None, :] == 0.0)
    logits = torch.where(mask & ~diag, NEG_INF, logits)
    return logits, diag, scores


def in_batch_softmax_block(
    user_emb: torch.Tensor,
    item_emb_all: torch.Tensor,
    item_idx_all: torch.Tensor,
    row_offset: int,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights_all: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row in-batch softmax CE for the rows ``[row_offset, row_offset +
    R)`` of the global batch against all ``B`` item columns.

    Returns ``(per_example [R], correct [R], raw_diag [R])`` — CE loss,
    top-1 indicator (``pos >= row max``, the kernel's tie rule) and the raw
    (untempered, uncorrected) positive score. Only ``per_example`` carries
    a gradient.
    """
    logits, diag, scores = _in_batch_logits(
        user_emb,
        item_emb_all,
        item_idx_all,
        row_offset,
        temperature=temperature,
        log_q=log_q,
        weights_all=weights_all,
    )
    lse = torch.logsumexp(logits, dim=-1)
    pos = torch.sum(torch.where(diag, logits, 0.0), dim=-1)
    per_example = lse - pos
    correct = (pos >= logits.max(dim=-1).values).float()
    raw_diag = torch.sum(torch.where(diag, scores, 0.0), dim=-1)
    return per_example, correct.detach(), raw_diag.detach()


def weighted_mean_metrics(
    per_example: torch.Tensor,
    correct: torch.Tensor,
    raw_diag: torch.Tensor,
    weights: torch.Tensor | None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted batch loss and the ``accuracy``/``logits_mean`` metrics."""
    if weights is None:
        weights = torch.ones_like(per_example)
    weights = weights.float()
    denom = torch.clamp(weights.sum(), min=1.0)
    loss = (per_example * weights).sum() / denom
    metrics = {
        "accuracy": (correct * weights).sum() / denom,
        "logits_mean": (raw_diag * weights).sum() / denom,
    }
    return loss, metrics


def in_batch_softmax_loss(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_idx: torch.Tensor,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """In-batch sampled softmax over the ``B x B`` score matrix.

    ``item_idx`` ``[B]`` int global item ids (accidental-hit masking and the
    log-Q lookup); ``log_q`` optional ``[num_items]`` log sampling
    probabilities; ``weights`` optional ``[B]`` (0 = padding row: neither
    contributes loss nor serves as a negative). Returns ``(scalar loss,
    {"accuracy", "logits_mean"})``.
    """
    per_example, correct, raw_diag = in_batch_softmax_block(
        user_emb,
        item_emb,
        item_idx,
        0,
        temperature=temperature,
        log_q=log_q,
        weights_all=weights,
    )
    return weighted_mean_metrics(per_example, correct, raw_diag, weights)


def l2_penalty(
    tower_params: dict, gathered_embeddings: list[torch.Tensor]
) -> torch.Tensor:
    """Sparse-friendly L2: dense tower kernels (not biases) plus only the
    embedding rows touched this step."""
    acc = torch.zeros((), device=gathered_embeddings[0].device)
    # Sorted names: the summation order of the JAX package's tree_leaves.
    for name in sorted(tower_params):
        for layer in tower_params[name]:
            acc = acc + torch.sum(layer["kernel"].float() ** 2)
    for emb in gathered_embeddings:
        acc = acc + torch.sum(emb.float() ** 2)
    return acc

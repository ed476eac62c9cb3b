"""Retrieval losses: in-batch sampled softmax with log-Q correction, and the
uniform and mixed sampled softmaxes (PyTorch).

Counterpart of ``twotower_tpu/ops/losses.py``. The in-batch loss here is
the plain version of the fused loss in ``ops/kernels.py``: the CPU path,
and the reference the CUDA kernels are held against. The uniform and mixed
losses are plain PyTorch on every device: the JAX package has no Pallas
kernel for them, and the fused kernels score a ``[B, B]`` candidate set, not
a ``[B, B + M]`` or ``[B, 1 + M]`` one.

Math (Yi et al. 2019, "Sampling-Bias-Corrected Neural Modeling"):
    s_ij   = <u_i, v_j> / temperature
    s'_ij  = s_ij - log q(item_j)          (log-Q correction, all columns)
    mask   s'_ij = -1e9  where item_j == item_i, j != i  (accidental hits)
    loss   = -sum_i w_i * log softmax(s'_i)_i / max(sum_i w_i, 1)
"""

from __future__ import annotations

import math

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


def mixed_softmax_block(
    user_emb: torch.Tensor,
    item_emb_all: torch.Tensor,
    item_idx_all: torch.Tensor,
    row_offset: int,
    neg_emb: torch.Tensor,
    neg_idx: torch.Tensor,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    log_uniform: float | None = None,
    weights_all: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row mixed-negative softmax CE for a row block of the global batch.

    Mixed Negative Sampling (Yang et al. 2020): each row's candidates are
    the B in-batch items plus M shared uniformly sampled items, each column
    corrected by the log-probability of its own sampler (in-batch columns
    ``log_q[item]``, uniform columns ``log_uniform`` = ``-log(num_items)``).
    ``log_q=None`` disables both corrections (their relative shift matters,
    so they gate together). Accidental hits (another column equal to the
    row's positive) are masked in both blocks. Returns ``(per_example [R],
    correct [R], raw_diag [R])`` as ``in_batch_softmax_block`` does.
    """
    if log_q is not None and log_uniform is None:
        raise ValueError(
            "mixed log-Q correction needs log_uniform (-log(num_items)): "
            "uniform columns were sampled uniformly, not by frequency"
        )
    logits, diag, scores = _in_batch_logits(
        user_emb,
        item_emb_all,
        item_idx_all,
        row_offset,
        temperature=temperature,
        log_q=log_q,
        weights_all=weights_all,
    )
    neg_logits = (user_emb.float() @ neg_emb.float().T) / temperature
    if log_q is not None:
        neg_logits = neg_logits - log_uniform
    row_item = item_idx_all[row_offset : row_offset + user_emb.shape[0]]
    neg_hit = neg_idx[None, :] == row_item[:, None]
    neg_logits = torch.where(neg_hit, NEG_INF, neg_logits)

    all_logits = torch.cat([logits, neg_logits], dim=1)
    lse = torch.logsumexp(all_logits, dim=-1)
    pos = torch.sum(torch.where(diag, logits, 0.0), dim=-1)
    per_example = lse - pos
    correct = (pos >= all_logits.max(dim=-1).values).float()
    raw_diag = torch.sum(torch.where(diag, scores, 0.0), dim=-1)
    return per_example, correct.detach(), raw_diag.detach()


def mixed_sampled_softmax_loss(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_idx: torch.Tensor,
    neg_item_emb: torch.Tensor,
    neg_idx: torch.Tensor,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    num_items: int | None = None,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mixed-negative sampled softmax over ``[B, B + M]`` logits
    (``retrieval.candidate_sampling: "mixed"``): in-batch negatives with
    log-Q correction plus ``M`` shared uniform negatives corrected by
    ``-log(num_items)``."""
    if log_q is not None and not num_items:
        raise ValueError("mixed sampling with log_q needs num_items")
    per_example, correct, raw_diag = mixed_softmax_block(
        user_emb,
        item_emb,
        item_idx,
        0,
        neg_item_emb,
        neg_idx,
        temperature=temperature,
        log_q=log_q,
        log_uniform=(-math.log(num_items) if num_items else None),
        weights_all=weights,
    )
    return weighted_mean_metrics(per_example, correct, raw_diag, weights)


def uniform_softmax_block(
    user_emb: torch.Tensor,
    pos_item_emb: torch.Tensor,
    neg_item_emb: torch.Tensor,
    pos_idx: torch.Tensor | None = None,
    neg_idx: torch.Tensor | None = None,
    *,
    temperature: float = 0.1,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row uniform-negative softmax CE: each row scores its own positive
    against the shared ``[N, D]`` negatives. Returns ``(per_example [R],
    correct [R], raw_diag [R])`` (``raw_diag`` the raw positive score);
    with ``pos_idx`` and ``neg_idx``, a negative equal to the row's positive
    is masked."""
    pos = torch.einsum("bd,bd->b", user_emb.float(), pos_item_emb.float())
    neg = user_emb.float() @ neg_item_emb.float().T
    if pos_idx is not None and neg_idx is not None:
        hit = neg_idx[None, :] == pos_idx[:, None]
        neg = torch.where(hit, NEG_INF, neg)
    logits = torch.cat([pos[:, None], neg], dim=1) / temperature
    per_example = -torch.log_softmax(logits, dim=-1)[:, 0]
    correct = (logits.argmax(dim=-1) == 0).float()
    return per_example, correct.detach(), pos.detach()


def uniform_sampled_softmax_loss(
    user_emb: torch.Tensor,
    pos_item_emb: torch.Tensor,
    neg_item_emb: torch.Tensor,
    *,
    temperature: float = 0.1,
    weights: torch.Tensor | None = None,
    pos_idx: torch.Tensor | None = None,
    neg_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Uniform-negative sampled softmax (``retrieval.candidate_sampling:
    "uniform"``): ``neg_item_emb`` ``[N, D]`` shared negatives for the whole
    batch (uniform q makes log-Q a constant shift, hence omitted)."""
    per_example, correct, raw_pos = uniform_softmax_block(
        user_emb,
        pos_item_emb,
        neg_item_emb,
        pos_idx,
        neg_idx,
        temperature=temperature,
    )
    return weighted_mean_metrics(per_example, correct, raw_pos, weights)

"""Loss dispatch on the tensors' device: the square in-batch loss and its
block form (a mesh rank's rows at ``row_offset``).

Counterpart of ``twotower_tpu/ops/dispatch.py``. CUDA tensors go to the
fused CUDA kernels (``ops/kernels.py``); CPU tensors go to the plain version
(``ops/losses.py``). There is no quiet plain branch on CUDA: the kernels
cover every batch and width (ragged edges are masked), and an input they do
not cover raises.
"""

from __future__ import annotations

import torch

from twotower_tpu_torch.ops import kernels, losses


def in_batch_softmax_loss_auto(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_idx: torch.Tensor,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    impl = {
        "cuda": kernels.fused_in_batch_softmax_loss,
        "cpu": losses.in_batch_softmax_loss,
    }.get(user_emb.device.type)
    if impl is None:
        raise ValueError(f"no in-batch loss for device {user_emb.device}")
    return impl(
        user_emb,
        item_emb,
        item_idx,
        temperature=temperature,
        log_q=log_q,
        weights=weights,
    )


def in_batch_softmax_block_auto(
    user_emb: torch.Tensor,
    item_emb_all: torch.Tensor,
    item_idx_all: torch.Tensor,
    row_offset: int,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights_all: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    impl = {
        "cuda": kernels.fused_in_batch_softmax_block,
        "cpu": losses.in_batch_softmax_block,
    }.get(user_emb.device.type)
    if impl is None:
        raise ValueError(f"no in-batch block loss for device {user_emb.device}")
    return impl(
        user_emb,
        item_emb_all,
        item_idx_all,
        row_offset,
        temperature=temperature,
        log_q=log_q,
        weights_all=weights_all,
    )

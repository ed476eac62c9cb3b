"""Losses, searches and the fused loss kernels of the PyTorch port.

The losses and the top-k MIPS searches are plain PyTorch; the fused loss's
CUDA kernels (``ops.kernels``, ``ops/csrc/``) are built at their first
launch, never at import, and are not re-exported here.
"""

from twotower_tpu_torch.ops.losses import (
    in_batch_softmax_loss,
    l2_penalty,
    mixed_sampled_softmax_loss,
    uniform_sampled_softmax_loss,
)
from twotower_tpu_torch.ops.topk import (
    topk_mips,
    topk_mips_approx,
    topk_mips_approx_sharded,
    topk_mips_sharded,
)

__all__ = [
    "in_batch_softmax_loss",
    "l2_penalty",
    "mixed_sampled_softmax_loss",
    "uniform_sampled_softmax_loss",
    "topk_mips",
    "topk_mips_approx",
    "topk_mips_approx_sharded",
    "topk_mips_sharded",
]

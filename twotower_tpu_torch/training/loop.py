"""Train-step factory (PyTorch).

Counterpart of ``make_train_step`` in ``twotower_tpu/training/loop.py``,
sparse branch only; the dense step, the Trainer and the segment runner are
queued in ROADMAP.md.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training.state import Adam, TrainState
from twotower_tpu_torch.utils.platform import resolve_device

TrainStepFn = Callable[[TrainState, dict, Any], tuple[TrainState, dict]]


def make_train_step(
    config: Config,
    optimizer: Adam,
    log_q: np.ndarray | torch.Tensor | None = None,
    *,
    num_items: int | None = None,
    device: str | torch.device | None = None,
) -> TrainStepFn:
    """Build the train step ``step(state, batch, rng)`` on ``device``
    (``cuda`` unless the caller asks for the CPU).

    ``batch`` is a dict of numpy arrays or tensors (``user_idx``,
    ``item_idx``, optional ``weight`` and the ``training.host_dedup`` keys);
    they are moved to the device. ``rng`` is a ``torch.Generator`` on the
    device for the dropout masks (or None at dropout 0). The step updates
    ``state``'s tensors in place and returns ``(new_state, metrics)``.
    """
    if not config.training.effective_sparse_updates():
        raise NotImplementedError(
            "the dense train step is not ported yet (ROADMAP.md, Queue 1: the dense step)"
        )
    from twotower_tpu_torch.training.sparse import make_sparse_step_fn

    dev = resolve_device(device)
    raw = make_sparse_step_fn(config, optimizer, num_items=num_items)
    lq = None if log_q is None else torch.as_tensor(log_q, dtype=torch.float32).to(dev)

    def step(state: TrainState, batch: dict, rng: Any):
        on_dev = {k: torch.as_tensor(v).to(dev, non_blocking=True) for k, v in batch.items()}
        return raw(state, on_dev, rng, lq)

    return step

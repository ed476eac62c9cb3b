"""Device resolution for the port's entry points.

Everything runs on the GPU unless the caller asks for the CPU by name (the
CPU tests do). A missing GPU is an error, never a quiet move to the CPU: a
run that silently trained on the host would report host numbers as GPU ones.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; ``"cpu"`` -> the CPU; raises if CUDA is asked
    for (explicitly or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU (its kernels then use their plain PyTorch versions)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

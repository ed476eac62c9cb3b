"""Device helpers for the PyTorch port."""

from twotower_tpu_torch.utils.platform import resolve_device

__all__ = ["resolve_device"]

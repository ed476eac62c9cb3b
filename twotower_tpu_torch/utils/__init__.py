"""Utilities of the PyTorch port: device resolution, checkpointing,
experiment tracking."""

from twotower_tpu_torch.utils.checkpoint import CheckpointManager
from twotower_tpu_torch.utils.platform import resolve_device
from twotower_tpu_torch.utils.tracking import (
    JsonlWriter,
    MetricWriter,
    StdoutWriter,
    build_writers,
)

__all__ = [
    "CheckpointManager",
    "JsonlWriter",
    "MetricWriter",
    "StdoutWriter",
    "build_writers",
    "resolve_device",
]

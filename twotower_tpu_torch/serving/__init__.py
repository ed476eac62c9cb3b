"""Serving for the PyTorch port: the retrieval index, the native CPU index
and the service."""

from twotower_tpu_torch.serving.cpu_index import CpuFlatIndex
from twotower_tpu_torch.serving.index import RetrievalIndex

__all__ = ["CpuFlatIndex", "RetrievalIndex"]

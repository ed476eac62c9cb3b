"""Serving for the PyTorch port: the retrieval index and the service."""

from twotower_tpu_torch.serving.index import RetrievalIndex

__all__ = ["RetrievalIndex"]

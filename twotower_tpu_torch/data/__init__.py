"""Data layer of the PyTorch port: columnar schema, preprocessing, vocab,
batch pipeline (its own copies of the JAX package's numpy modules)."""

from twotower_tpu_torch.data.base import DataLoader, DataProcessor, DataSaver, DataValidator

from twotower_tpu_torch.data.pipeline import BatchPipeline, DevicePrefetcher, torch_put
from twotower_tpu_torch.data.preprocess import InteractionFilter, Preprocessor, Splits
from twotower_tpu_torch.data.schema import Interactions, from_columns, from_dataframe
from twotower_tpu_torch.data.synthetic import generate_interactions
from twotower_tpu_torch.data.vocab import VocabPair, Vocabulary

__all__ = [
    "DataLoader",
    "DataProcessor",
    "DataSaver",
    "DataValidator",
    "BatchPipeline",
    "DevicePrefetcher",
    "InteractionFilter",
    "Interactions",
    "Preprocessor",
    "Splits",
    "VocabPair",
    "Vocabulary",
    "from_columns",
    "from_dataframe",
    "generate_interactions",
    "torch_put",
]

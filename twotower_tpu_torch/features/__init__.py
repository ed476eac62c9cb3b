"""Feature layer of the PyTorch port: columnar feature engineering and the
hashed n-gram text encoder (its own copies of the JAX package's numpy
modules; the transformer encoder is not ported yet)."""

from twotower_tpu_torch.features.engineer import FeatureEngineer
from twotower_tpu_torch.features.text_encoder import HashedNgramEncoder, select_first_item_texts

__all__ = ["FeatureEngineer", "HashedNgramEncoder", "select_first_item_texts"]

"""Feature layer of the PyTorch port: columnar feature engineering and the
item text encoders (its own copies of the JAX package's modules): the hashed
n-gram encoder, and the HF-transformer encoder, which imports
``transformers`` only to load a model directory and so is not re-exported
here, as in the JAX package."""

from twotower_tpu_torch.features.engineer import FeatureEngineer
from twotower_tpu_torch.features.text_encoder import HashedNgramEncoder, select_first_item_texts

__all__ = ["FeatureEngineer", "HashedNgramEncoder", "select_first_item_texts"]

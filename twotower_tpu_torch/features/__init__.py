"""Feature layer of the PyTorch port: columnar feature engineering (its own
copy of the JAX package's numpy module; the text encoders wait for the text
tower)."""

from twotower_tpu_torch.features.engineer import FeatureEngineer

__all__ = ["FeatureEngineer"]

"""Two-tower model of the PyTorch port: pure functions over a dict of
parameters, in the JAX package's layout."""

from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.models.two_tower import (
    embed_item_table,
    embed_items,
    embed_users,
    forward,
    init_params,
    param_count,
)

__all__ = [
    "two_tower",
    "init_params",
    "forward",
    "embed_users",
    "embed_items",
    "embed_item_table",
    "param_count",
]

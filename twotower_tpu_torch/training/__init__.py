"""Training of the PyTorch port: state, optimizer, sparse step."""

from twotower_tpu_torch.training.loop import make_train_step
from twotower_tpu_torch.training.state import (
    Adam,
    TrainState,
    init_train_state,
    make_optimizer,
)

__all__ = ["Adam", "TrainState", "init_train_state", "make_optimizer", "make_train_step"]

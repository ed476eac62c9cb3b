"""Training of the PyTorch port: state, optimizer, sparse step, Trainer."""

from twotower_tpu_torch.training.loop import Trainer, TrainResult, make_train_step
from twotower_tpu_torch.training.state import (
    Adam,
    TrainState,
    init_train_state,
    make_optimizer,
)

__all__ = [
    "Adam",
    "TrainResult",
    "TrainState",
    "Trainer",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
]

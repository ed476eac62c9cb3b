"""Training of the PyTorch port: state, optimizers, the sparse and dense
steps, Trainer."""

from twotower_tpu_torch.training.loop import Trainer, TrainResult, make_train_step
from twotower_tpu_torch.training.state import (
    Adagrad,
    Adam,
    Sgd,
    TrainState,
    init_train_state,
    make_optimizer,
)

__all__ = [
    "Adagrad",
    "Adam",
    "Sgd",
    "TrainResult",
    "TrainState",
    "Trainer",
    "init_train_state",
    "make_optimizer",
    "make_train_step",
]

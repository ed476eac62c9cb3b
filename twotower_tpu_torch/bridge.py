"""Carry weights and train state between the JAX package and the port.

Both sides meet in numpy, so this module imports neither JAX nor the JAX
package. The layouts are the JAX package's:

- params: ``{"user_embedding": [U, E], "item_embedding": [I, E],
  "user_tower"/"item_tower": [{"kernel": [in, out], "bias": [out]}, ...]}``;
- sparse train state: ``{"step": int, "params": <params>, "opt_state":
  {"count": int, "mu": <dense params>, "nu": <dense params>},
  "table_state": {table: {"moments": [rows, 2E]}}}`` — ``opt_state`` is
  optax's ``ScaleByAdamState`` of the dense towers, ``table_state`` the
  packed lazy-Adam moments.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from twotower_tpu_torch.training.state import AdamState, TrainState, tree_map


def params_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """numpy parameter tree -> the port's tensors (float32, copies)."""
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device), tree
    )


def params_to_numpy(tree: Any) -> Any:
    """The port's tensors -> numpy parameter tree (host copies)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def state_from_numpy(tree: dict, device: str | torch.device = "cpu") -> TrainState:
    """numpy sparse train state -> ``TrainState`` on ``device``."""
    opt = tree["opt_state"]
    return TrainState(
        step=int(tree["step"]),
        params=params_from_numpy(tree["params"], device),
        opt_state=AdamState(
            count=int(opt["count"]),
            mu=params_from_numpy(opt["mu"], device),
            nu=params_from_numpy(opt["nu"], device),
        ),
        table_state=params_from_numpy(tree["table_state"], device),
    )


def state_to_numpy(state: TrainState) -> dict:
    """``TrainState`` -> numpy sparse train state."""
    return {
        "step": int(state.step),
        "params": params_to_numpy(state.params),
        "opt_state": {
            "count": int(state.opt_state.count),
            "mu": params_to_numpy(state.opt_state.mu),
            "nu": params_to_numpy(state.opt_state.nu),
        },
        "table_state": params_to_numpy(state.table_state),
    }

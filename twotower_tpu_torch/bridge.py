"""Carry weights and train state between the JAX package and the port.

Both sides meet in numpy, so this module imports neither JAX nor the JAX
package. The layouts are the JAX package's:

- params: ``{"user_embedding": [U, E], "item_embedding": [I, E],
  "user_tower"/"item_tower": [{"kernel": [in, out], "bias": [out]}, ...]}``;
- train state: ``{"step": int, "params": <params>, "opt_state": {"count":
  int, <slots>}, "table_state": {table: {"moments": [rows, 2E]}} or
  None}``. The slots are the optimizer's state trees by optax's field
  names: ``mu`` and ``nu`` (``ScaleByAdamState``; adam and adamw),
  ``sum_of_squares`` (``ScaleByRssState``; adagrad), none (sgd); ``count``
  is the update count (optax's adam or schedule count). On the sparse path
  the slots cover the dense towers and ``table_state`` holds the packed
  lazy-Adam moments; on the dense path the slots cover every parameter and
  ``table_state`` is None.

On a mesh, ``sharded_state_from_numpy`` gives each rank its shard of the
port's state and ``gathered_state_to_numpy`` gathers the shards back.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from twotower_tpu_torch.training.state import (
    TrainState,
    opt_state_from_tree,
    opt_state_to_tree,
    tree_map,
)


def params_from_numpy(tree: Any, device: str | torch.device = "cpu") -> Any:
    """numpy parameter tree -> the port's tensors (float32, copies)."""
    if tree is None:
        return None
    return tree_map(
        lambda a: torch.tensor(np.asarray(a), dtype=torch.float32, device=device), tree
    )


def params_to_numpy(tree: Any) -> Any:
    """The port's tensors -> numpy parameter tree (host copies)."""
    if tree is None:
        return None
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


def state_from_numpy(tree: dict, device: str | torch.device = "cpu") -> TrainState:
    """numpy train state -> ``TrainState`` on ``device``."""
    opt = tree["opt_state"]
    slots = {k: params_from_numpy(v, device) for k, v in opt.items() if k != "count"}
    return TrainState(
        step=int(tree["step"]),
        params=params_from_numpy(tree["params"], device),
        opt_state=opt_state_from_tree({"count": int(opt["count"]), **slots}),
        table_state=params_from_numpy(tree["table_state"], device),
    )


def state_to_numpy(state: TrainState) -> dict:
    """``TrainState`` -> numpy train state."""
    opt = opt_state_to_tree(state.opt_state)
    return {
        "step": int(state.step),
        "params": params_to_numpy(state.params),
        "opt_state": {k: v if k == "count" else params_to_numpy(v) for k, v in opt.items()},
        "table_state": params_to_numpy(state.table_state),
    }


def sharded_state_from_numpy(tree: dict, mesh, config) -> TrainState:
    """numpy train state (the JAX package's global arrays) -> this rank's
    shard of the port's state on ``mesh`` (``parallel.sharding.shard_state``
    in the layout ``TrainState.for_config(mesh=)`` gives ``config``)."""
    from twotower_tpu_torch.parallel.sharding import shard_state
    from twotower_tpu_torch.parallel.sparse_spmd import use_sparse_mesh_path

    return shard_state(mesh, state_from_numpy(tree), config.mesh,
                       sparse_mesh=use_sparse_mesh_path(config))


def gathered_state_to_numpy(state: TrainState) -> dict:
    """A sharded ``TrainState`` -> the numpy train state of the whole model
    (a collective: every rank of the mesh calls it)."""
    from twotower_tpu_torch.parallel.sharding import gather_state

    return state_to_numpy(gather_state(state))

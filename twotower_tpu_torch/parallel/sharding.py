"""Sharding rules: which state leaves are row-sharded, over which axis, and
the moves between a full state and this rank's shard of it.

Counterpart of ``twotower_tpu/parallel/sharding.py``. The leaves are
matched by path, as in JAX: any leaf under a key naming an embedding table
(``user_embedding``, ``item_embedding``, ``text_embedding``) with two
dimensions is a table leaf, which covers the optimizer slots that mirror
the parameters (``mu``/``nu``, ``sum_of_squares``) and the packed lazy-Adam
moments. Table leaves are row-sharded:

- sparse mesh path (``parallel/sparse_spmd.py``): over the combined
  ``(data, model)`` axis, every rank owning distinct rows (JAX
  ``P((data, model), None)``);
- dense mesh path (``parallel/spmd.py``): over ``model``, replicated along
  ``data`` (JAX ``P(model, None)``);
- ``mesh.shard_embeddings=false``: replicated.

Everything else (tower params, their optimizer slots, counters) is
replicated. Batches split over ``data``: data shard ``d`` holds global rows
``[d * B/D, (d+1) * B/D)``.

A sharded ``TrainState`` carries its ``StateSharding`` (``state.sharding``),
from which a checkpoint save knows which rows each rank writes and a
restore which rows each rank reads (``utils/checkpoint.py``): neither
gathers. ``gather_state``, ``gather_tree`` and ``gather_params`` assemble
the whole state on every rank; the bridge and the tests use them, and no
save, restore or evaluation does.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch

from twotower_tpu_torch.config import MeshConfig
from twotower_tpu_torch.parallel.mesh import Mesh

TABLE_NAMES = ("user_embedding", "item_embedding", "text_embedding")


@dataclass(frozen=True, eq=False)
class StateSharding:
    """How a state lives on a mesh: the mesh and whether it has the sparse
    path's layout (tables over the combined axis) or the dense one."""

    mesh: Mesh
    sparse_mesh: bool


def table_axis(config: MeshConfig, *, sparse_mesh: bool = False) -> str | None:
    """The axis a table's rows are sharded over: ``combined`` on the sparse
    path, ``model`` on the dense one, None (replicated) without
    ``shard_embeddings``."""
    if not config.shard_embeddings:
        return None
    return "combined" if sparse_mesh else "model"


def _map_with_path(fn, tree: Any, path: tuple = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, (*path, i)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _zip_map(fn, tree: Any, axes: Any) -> Any:
    """``fn(leaf, axis)`` over a tree and its ``leaf_axes``."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, axes[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, a) for v, a in zip(tree, axes)]
    return fn(tree, axes)


def is_table_leaf(path: tuple, leaf: Any) -> bool:
    return any(t in path for t in TABLE_NAMES) and getattr(leaf, "ndim", 0) == 2


def leaf_axes(tree: Any, config: MeshConfig, *, sparse_mesh: bool = False) -> Any:
    """The tree of each leaf's sharding axis (``None``: replicated): the rule
    ``shard_tree`` and ``gather_tree`` apply."""
    axis = table_axis(config, sparse_mesh=sparse_mesh)
    return _map_with_path(lambda p, x: axis if is_table_leaf(p, x) else None, tree)


def _rows_of(t: torch.Tensor, size: int, index: int) -> torch.Tensor:
    if t.shape[0] % size:
        raise ValueError(f"table rows {t.shape[0]} not divisible by the {size}-rank axis "
                         "(pad tables to a multiple)")
    n = t.shape[0] // size
    return t[index * n:(index + 1) * n]


def shard_tree(tree: Any, mesh: Mesh, config: MeshConfig, *, sparse_mesh: bool = False) -> Any:
    """A full tree -> this rank's shard of it, on the mesh's device (copies)."""
    def one(x, axis):
        if not isinstance(x, torch.Tensor):
            return x
        if axis is not None:
            ax = mesh.axis(axis)
            x = _rows_of(x, ax.size, ax.index)
        return x.to(mesh.device, copy=True).contiguous()

    return _zip_map(one, tree, leaf_axes(tree, config, sparse_mesh=sparse_mesh))


def gather_tree(tree: Any, mesh: Mesh, config: MeshConfig, *, sparse_mesh: bool = False) -> Any:
    """This rank's shard -> the full tree, a snapshot that later in-place
    steps do not change (a collective: every rank calls it, and every rank
    gets the full tree)."""
    def one(x, axis):
        if not isinstance(x, torch.Tensor):
            return x
        if axis is not None:
            return mesh.axis(axis).all_gather(x)
        return x.detach().clone()

    return _zip_map(one, tree, leaf_axes(tree, config, sparse_mesh=sparse_mesh))


def shard_state(mesh: Mesh, state, config: MeshConfig | None = None, *,
                sparse_mesh: bool = False):
    """A full ``TrainState`` -> this rank's shard, on the mesh's device, with
    its ``sharding`` set."""
    from twotower_tpu_torch.utils.checkpoint import state_to_tree, tree_to_state

    config = config or mesh.config
    tree = shard_tree(state_to_tree(state), mesh, config, sparse_mesh=sparse_mesh)
    return replace(tree_to_state(tree), sharding=StateSharding(mesh, sparse_mesh))


def gather_state(state):
    """A sharded ``TrainState`` -> the full one, on every rank (collective).
    A state without ``sharding`` is returned as it is."""
    from twotower_tpu_torch.utils.checkpoint import state_to_tree, tree_to_state

    sh = state.sharding
    if sh is None:
        return state
    tree = gather_tree(state_to_tree(state), sh.mesh, sh.mesh.config,
                       sparse_mesh=sh.sparse_mesh)
    return replace(tree_to_state(tree), sharding=None)


def gather_params(params: dict, sharding: StateSharding | None) -> dict:
    """Full parameters from this rank's shard (collective); as they are
    without a sharding."""
    if sharding is None:
        return params
    return gather_tree(params, sharding.mesh, sharding.mesh.config,
                       sparse_mesh=sharding.sparse_mesh)


def process_row_spans(mesh: Mesh, global_rows: int) -> list[tuple[int, int]]:
    """The ``[lo, hi)`` spans of each global batch that this rank supplies:
    its data shard's rows (model peers of one data shard feed the same
    rows)."""
    if global_rows % mesh.num_data:
        raise ValueError(f"batch of {global_rows} rows does not split over "
                         f"{mesh.num_data} data shards")
    per = global_rows // mesh.num_data
    return [(mesh.d_idx * per, (mesh.d_idx + 1) * per)]


def data_rows(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """This rank's data shard of a global batch column."""
    (lo, hi), = process_row_spans(mesh, t.shape[0])
    return t[lo:hi]

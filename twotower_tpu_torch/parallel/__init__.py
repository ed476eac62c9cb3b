"""Parallelism on ``torch.distributed``: the mesh, the sharding rules, the
all-to-all lookups and row updates, and the mesh train and eval steps."""

from twotower_tpu_torch.parallel.a2a import (
    alltoall_lookup,
    alltoall_row_update,
    psum_lookup,
    sharded_embedding_lookup,
)
from twotower_tpu_torch.parallel.mesh import Mesh, build_mesh, initialize_multihost
from twotower_tpu_torch.parallel.sharding import (
    StateSharding,
    gather_state,
    process_row_spans,
    shard_state,
)
from twotower_tpu_torch.parallel.sparse_spmd import (
    make_sparse_sharded_train_step,
    use_sparse_mesh_path,
)
from twotower_tpu_torch.parallel.spmd import (
    make_dense_sharded_step,
    make_mesh_loss,
    make_sharded_eval_step,
    make_sharded_train_step,
)

__all__ = [
    "Mesh",
    "StateSharding",
    "alltoall_lookup",
    "alltoall_row_update",
    "build_mesh",
    "gather_state",
    "initialize_multihost",
    "make_dense_sharded_step",
    "make_mesh_loss",
    "make_sharded_eval_step",
    "make_sharded_train_step",
    "make_sparse_sharded_train_step",
    "process_row_spans",
    "psum_lookup",
    "shard_state",
    "sharded_embedding_lookup",
    "use_sparse_mesh_path",
]

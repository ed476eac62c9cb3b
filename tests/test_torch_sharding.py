"""The port's sharding rules (``parallel/sharding.py``) against the JAX
package's: which leaves are row-sharded over which axis, each rank's shard
of a state against JAX's placement on the matching device, the gather back,
and ``init_train_state(mesh=)`` giving the one-device model at every world
size."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as workers
from test_torch_bridge import numpy_to_jax_state
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_jax import BASE, LAYOUTS, NUM_ITEMS, NUM_USERS, jax_config, jax_mesh, jax_start
from torch_mesh_jax import layout_id
from torch_mesh_ranks import flatten, run_ranks
from twotower_tpu.parallel import shard_state as jax_shard_state
from twotower_tpu.parallel.sharding import state_pspecs
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.parallel.sharding import leaf_axes
from twotower_tpu_torch.training.state import init_train_state, make_optimizer

CASES = {
    "sparse": ({}, True),
    "dense_adamw": ({"training.optimizer": "adamw", "training.weight_decay": 0.01}, False),
    "dense_adagrad": ({"training.optimizer": "adagrad"}, False),
    "unsharded": ({"mesh.shard_embeddings": False, "training.optimizer": "sgd"}, False),
}


def _jax_axis(spec, cfg) -> str | None:
    if spec == P():
        return None
    return {P((cfg.mesh.data_axis, cfg.mesh.model_axis), None): "combined",
            P(cfg.mesh.model_axis, None): "model", P(None, None): None}[spec]


@pytest.mark.parametrize("case", CASES)
def test_leaf_axes_match_jax_state_pspecs(case):
    """Params and lazy-Adam moments: the axis of JAX's ``state_pspecs`` for
    each leaf; the optimizer's slots (``mu``/``nu``, ``sum_of_squares``)
    mirror their parameter's axis, as JAX's path rule gives them."""
    from twotower_tpu_torch.utils.checkpoint import state_to_tree

    over, sparse = CASES[case]
    cfg = jax_config(over, (2, 2))
    start = jax_start(cfg, sparse=sparse)
    jstate = numpy_to_jax_state(start, jax_make_optimizer(cfg.training))
    specs = state_pspecs(jstate, cfg.mesh, sparse_mesh=sparse)
    port_cfg = Config().with_overrides({**BASE, **over})
    got = flatten(leaf_axes(state_to_tree(bridge.state_from_numpy(start)), port_cfg.mesh,
                            sparse_mesh=sparse))
    got = {k: str(v) for k, v in got.items()}  # replicated (None) leaves drop out
    is_p = lambda x: isinstance(x, P)  # noqa: E731
    for part in ("params", "table_state"):
        tree = getattr(jstate, part)
        if tree is None:
            continue
        for path, spec in zip(_paths(tree, part),
                              jax.tree_util.tree_leaves(getattr(specs, part), is_leaf=is_p)):
            assert got.get(path) == _jax_axis(spec, cfg), path
    for k, v in got.items():
        if k.startswith("opt_state/") and k.count("/") >= 2:
            assert v == got["params/" + k.split("/", 2)[2]], k
    sharded = {k for k, v in got.items() if v is not None}
    assert bool(sharded) == cfg.mesh.shard_embeddings
    assert all("_embedding" in k for k in sharded)


def _paths(tree, prefix):
    return list(flatten(jax.tree_util.tree_map(lambda _: 0, tree), prefix))


@pytest.mark.parametrize("layout", LAYOUTS, ids=layout_id)
@pytest.mark.parametrize("case", ["sparse", "dense_adamw"])
def test_rank_shards_match_jax_placement(tmp_path, layout, case):
    over, sparse = CASES[case]
    cfg = jax_config(over, layout)
    start = jax_start(cfg, sparse=sparse)
    mesh = jax_mesh(cfg, layout)
    jstate = jax_shard_state(mesh, numpy_to_jax_state(start, jax_make_optimizer(cfg.training)),
                             cfg.mesh, sparse_mesh=sparse)
    spec = {"overrides": {**BASE, **over, "mesh.num_model": layout[1]}, "state": start,
            "num_users": NUM_USERS, "num_items": NUM_ITEMS}
    out = run_ranks(workers.shards, layout[0] * layout[1], tmp_path, spec)
    port_cfg = Config().with_overrides(spec["overrides"])
    one = flatten(bridge.state_to_numpy(init_train_state(
        port_cfg, make_optimizer(port_cfg.training), NUM_USERS, NUM_ITEMS, device="cpu")))
    full = flatten(start)
    table = jstate.params["user_embedding"]
    for rank, got in enumerate(out):
        assert bool(got["sparse"]) == sparse
        device = mesh.devices.reshape(-1)[rank]
        shard = next(s for s in table.addressable_shards if s.device == device)
        np.testing.assert_array_equal(got["local/params/user_embedding"], np.asarray(shard.data))
        for k, v in full.items():
            np.testing.assert_array_equal(got[f"gathered/{k}"], v, err_msg=k)
        for k, v in one.items():  # one seed, one model, at every world size
            np.testing.assert_array_equal(got[f"fresh/{k}"], v, err_msg=k)

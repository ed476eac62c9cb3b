"""The port's explicit-collective lookups and distributed row update
(``parallel/a2a.py``) on gloo ranks on the CPU, against a dense gather and
against the JAX package's ``parallel/a2a.py`` under ``shard_map`` on
conftest's virtual devices (``tests/test_a2a.py``'s cases): rows rtol 1e-6,
gradients and updates rtol 1e-5 / atol 1e-6, and the same drop counts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_ranks import run_ranks
from twotower_tpu.parallel.a2a import alltoall_lookup, alltoall_row_update
from twotower_tpu.parallel.a2a import sharded_embedding_lookup as jax_lookup

ROWS_PER_SHARD, DIM = 16, 8


def _spec(world: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    rows = world * ROWS_PER_SHARD
    ids = rng.integers(0, rows, (world, 24)).astype(np.int32)
    ids[0, 5] = ids[world - 1, 7]  # the same id from two ranks
    ids[0, 1] = ids[0, 2]  # a duplicate within one rank
    return {
        "table": rng.normal(size=(rows, DIM)).astype(np.float32),
        "moments": (np.abs(rng.normal(size=(rows, 2 * DIM))) * 0.01).astype(np.float32),
        "ids": ids,
        "shared": np.array([3, 3, 3, 17, rows - 1, 0, 0, rows // 2], np.int32),
        "scale": rng.uniform(0.5, 2.0, 24).astype(np.float32),
        # Six ids on shard 0 with capacity 4: two drop; the shard-3 ids resolve.
        "tight_ids": np.array([0, 1, 2, 3, 4, 5, 50 % rows, 50 % rows], np.int32),
        "capacity": 4,
        "row_grads": rng.normal(size=(world, 24, DIM)).astype(np.float32),
        "update_capacity": 4,
    }


@pytest.fixture(scope="module", params=[2, 4], ids=lambda w: f"world{w}")
def ranks(request, tmp_path_factory):
    world = request.param
    spec = _spec(world)
    return world, spec, run_ranks(workers.lookups, world, tmp_path_factory.mktemp("a2a"), spec)


def _jax_mesh(world):
    return Mesh(np.array(jax.devices()[:world]), ("model",))


@pytest.mark.parametrize("strategy", ["alltoall", "psum"])
def test_lookup_and_gradient_match_a_dense_gather(ranks, strategy):
    """Each rank's rows equal ``table[ids]``; the table's gradient is the
    dense scatter-add of every rank's row cotangents."""
    world, spec, out = ranks
    table = spec["table"]
    grad = np.zeros_like(table)
    for r in range(world):
        ids = spec["ids"][r] if strategy == "alltoall" else spec["shared"]
        rows = table[ids]
        np.testing.assert_allclose(out[r][f"{strategy}/rows"], rows, rtol=1e-6)
        np.add.at(grad, ids, 2 * rows * spec["scale"][:len(ids), None])
    for r in range(world):
        np.testing.assert_allclose(out[r][f"{strategy}/grad"], grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("strategy", ["alltoall", "psum"])
def test_replicated_lookup_matches_jax(ranks, strategy):
    """The replicated form against JAX's ``sharded_embedding_lookup`` and
    ``jax.grad`` through it: rows and the gradient of ``sum(rows**2)``."""
    world, spec, out = ranks
    mesh = _jax_mesh(world)
    table = jax.device_put(jnp.asarray(spec["table"]), NamedSharding(mesh, P("model", None)))
    ids = jnp.asarray(spec["shared"])

    def loss(t):
        rows = jax_lookup(mesh, t, ids, strategy=strategy)
        return jnp.sum(rows * rows)

    rows = np.asarray(jax_lookup(mesh, table, ids, strategy=strategy))
    grad = np.asarray(jax.grad(loss)(table))
    for r in range(world):
        np.testing.assert_allclose(out[r][f"{strategy}_replicated/rows"], rows, rtol=1e-6)
        np.testing.assert_allclose(out[r][f"{strategy}_replicated/grad"], grad, rtol=1e-5,
                                   atol=1e-6)


def test_tight_capacity_drops_as_jax(ranks):
    world, spec, out = ranks
    mesh = _jax_mesh(world)
    table = jax.device_put(jnp.asarray(spec["table"]), NamedSharding(mesh, P("model", None)))
    rows, dropped = shard_map(
        lambda t, i: alltoall_lookup(t, i, axis_name="model", capacity=spec["capacity"],
                                     return_stats=True),
        mesh=mesh, in_specs=(P("model", None), P()), out_specs=(P(), P()), check_rep=False,
    )(table, jnp.asarray(spec["tight_ids"]))
    for r in range(world):
        assert out[r]["tight/dropped"] == int(dropped) == 2
        np.testing.assert_allclose(out[r]["tight/rows"][:4], spec["table"][:4], rtol=1e-6)
        np.testing.assert_allclose(out[r]["tight/rows"][-2:],
                                   spec["table"][spec["tight_ids"][-2:]], rtol=1e-6)


@pytest.mark.parametrize("which", ["update", "update_tight"])
def test_row_update_matches_jax(ranks, which):
    """``alltoall_row_update`` against JAX's: owner-side dedup of duplicates
    within and across ranks, packed lazy Adam at step 3; with capacity 4
    the same drops, and rows on no route untouched."""
    world, spec, out = ranks
    mesh = _jax_mesh(world)
    cap = None if which == "update" else spec["update_capacity"]

    def body(t, mo, i, g):
        nt, nmo, nsq, drop = alltoall_row_update(
            t, mo, i, g, axis_name="model", capacity=cap, lr=jnp.float32(1e-3),
            step=jnp.int32(3))
        return nt, nmo, jax.lax.psum(nsq, "model"), jax.lax.psum(drop, "model")

    sh = NamedSharding(mesh, P("model", None))
    new_t, new_mo, norm_sq, dropped = shard_map(
        body, mesh=mesh,
        in_specs=(P("model", None), P("model", None), P("model"), P("model", None)),
        out_specs=(P("model", None), P("model", None), P(), P()), check_rep=False,
    )(jax.device_put(jnp.asarray(spec["table"]), sh),
      jax.device_put(jnp.asarray(spec["moments"]), sh),
      jnp.asarray(spec["ids"].reshape(-1)), jnp.asarray(spec["row_grads"].reshape(-1, DIM)))
    got = out[0]
    assert got[f"{which}/dropped"] == int(dropped)
    assert (int(dropped) > 0) == (cap is not None)
    np.testing.assert_allclose(got[f"{which}/table"], np.asarray(new_t), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[f"{which}/moments"], np.asarray(new_mo), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got[f"{which}/norm_sq"], float(norm_sq), rtol=1e-5)

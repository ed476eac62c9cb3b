"""The JAX side of the port's mesh tests: the JAX package's mesh step
functions on the first ``D*S`` of conftest's 8 virtual CPU devices, and the
comparisons. Only the parent test process imports this module (the ranks
run ``torch_mesh_workers``, which imports no JAX)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_bridge import jax_state_to_numpy, numpy_to_jax_state
from torch_mesh_ranks import flatten
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.parallel import build_mesh, make_sharded_train_step, shard_state
from twotower_tpu.parallel.sharding import batch_shardings, replicated
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer

# (num_data, num_model) layouts of the mesh tests.
LAYOUTS = [(2, 1), (1, 2), (4, 1), (2, 2), (1, 4)]
NUM_USERS, NUM_ITEMS, BATCH = 300, 200, 32
BASE = {
    "model.embedding_dim": 16,
    "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
    "model.dropout_rate": 0.0,
    "model.compute_dtype": "float32",
    "training.batch_size": BATCH,
    "training.sparse_table_updates": True,
}
# The JAX package's own tolerances (tests/test_sparse_spmd.py): one step,
# and several (Adam's 1/sqrt(nu) amplifies reduction-order noise).
ONE_STEP = dict(rtol=1e-4, atol=1e-6)
MULTI_STEP = dict(rtol=5e-3, atol=5e-4)


def layout_id(layout) -> str:
    return f"{layout[0]}x{layout[1]}"


def devices(n: int):
    d = jax.devices()
    assert len(d) >= n, "conftest provides 8 virtual CPU devices"
    return d[:n]


def jax_mesh(cfg, layout):
    d, s = layout
    return build_mesh(cfg.mesh, devices(d * s))


def batches(n: int, *, batch: int = BATCH, seed: int = 1, num_items: int = NUM_ITEMS):
    """Global batches as ``tests/test_sparse_spmd.py:_setup`` builds them:
    cross-shard duplicate positives and users, zero-weight padding rows."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = rng.integers(0, NUM_USERS, batch).astype(np.int32)
        i = rng.integers(0, num_items, batch).astype(np.int32)
        i[3] = i[17]
        u[2] = u[30 % batch]
        w = np.ones(batch, np.float32)
        w[-2:] = 0.0
        out.append({"user_idx": u, "item_idx": i, "weight": w})
    return out


def log_q_for(rows: int, seed: int = 5) -> np.ndarray:
    return np.log(np.random.default_rng(seed).uniform(0.01, 1.0, rows)).astype(np.float32)


def jax_config(overrides: dict, layout) -> JaxConfig:
    return JaxConfig().with_overrides({**BASE, **overrides, "mesh.num_model": layout[1]})


def jax_start(cfg, *, sparse: bool, seed: int = 0) -> dict:
    """A fresh JAX state (sparse or dense layout) in the bridge's numpy form."""
    from twotower_tpu.models import two_tower
    from twotower_tpu.training.state import TrainState

    params = two_tower.init_params(jax.random.PRNGKey(seed), cfg.model, NUM_USERS, NUM_ITEMS)
    opt = jax_make_optimizer(cfg.training)
    state = (TrainState.for_config(params, opt, cfg) if sparse
             else TrainState.create(params, opt))
    return jax_state_to_numpy(state)


def jax_negatives(cfg, n_steps: int, rng_seed: int, num_items: int = NUM_ITEMS) -> list:
    """The negatives the JAX mesh step draws at steps ``0..n-1``:
    ``fold_in(fold_in(rng, step), 0x5E9)`` (``sparse_spmd.py``)."""
    if cfg.retrieval.candidate_sampling == "in_batch":
        return None
    rng = jax.random.PRNGKey(rng_seed)
    return [np.asarray(jax.random.randint(
        jax.random.fold_in(jax.random.fold_in(rng, t), 0x5E9),
        (cfg.retrieval.num_negatives,), 0, num_items, dtype=jnp.int32)) for t in range(n_steps)]


def jax_mesh_steps(cfg, layout, start: dict, batch_list: list, *, log_q=None,
                   item_tokens=None, num_items=None, rng_seed: int = 7, sparse: bool = True):
    """The JAX package's ``make_sharded_train_step`` over ``batch_list`` from
    the numpy state ``start``: ``(metrics by step, final numpy state)``."""
    mesh = jax_mesh(cfg, layout)
    opt = jax_make_optimizer(cfg.training)
    state = numpy_to_jax_state(start, opt)
    sharded = shard_state(mesh, state, cfg.mesh, sparse_mesh=sparse)
    step = make_sharded_train_step(
        cfg, opt, mesh, sharded, None if log_q is None else jnp.asarray(log_q), donate=False,
        item_tokens=None if item_tokens is None else jnp.asarray(item_tokens),
        num_items=num_items)
    b_sh = batch_shardings(mesh, cfg.mesh)
    rng = jax.device_put(jax.random.PRNGKey(rng_seed), replicated(mesh))
    metrics = []
    for b in batch_list:
        sharded, m = step(sharded, {k: jax.device_put(jnp.asarray(v), b_sh)
                                    for k, v in b.items()}, rng)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax_state_to_numpy(sharded)


def assert_metrics_close(got: dict, want: dict, i: int, *, loss_rtol: float = 2e-5,
                         acc_atol: float = 1e-6, norm_rtol: float = 1e-4):
    """The JAX tests' metric tolerances, on the port's flat metrics of step
    ``i`` (``metrics/{i}/<name>``)."""
    np.testing.assert_allclose(got[f"metrics/{i}/loss"], want["loss"], rtol=loss_rtol)
    np.testing.assert_allclose(got[f"metrics/{i}/accuracy"], want["accuracy"], atol=acc_atol)
    np.testing.assert_allclose(got[f"metrics/{i}/grad_norm"], want["grad_norm"],
                               rtol=norm_rtol)
    if "dropped_ids" in want:
        assert float(got[f"metrics/{i}/dropped_ids"]) == want["dropped_ids"]


def assert_state_close(got: dict, want: dict, *, lr: float, steps: int, rtol: float,
                       atol: float, prefix: str = "state"):
    """Every leaf of the port's gathered state (flat, ``prefix/...``) against
    JAX's numpy state. An element of a table or its moments whose Adam
    update was near a cancelled gradient may differ by the step's size;
    it is held to ``lr`` a step instead (ROADMAP.md, Queue 3)."""
    flat = flatten(want, prefix)
    assert set(flat) <= set(got), sorted(set(flat) - set(got))
    for k, v in flat.items():
        g = got[k]
        assert g.shape == v.shape, k
        if not np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_equal(g, v, err_msg=k)
            continue
        close = np.isclose(g, v, rtol=rtol, atol=atol)
        if not close.all():
            assert np.abs(g - v)[~close].max() <= lr * steps, k
            assert close.mean() >= 0.999, k

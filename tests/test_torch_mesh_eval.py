"""The port's sharded evaluation, searches, device-loop epoch and mesh
checkpoints, against the JAX package and against the port's one-device
path, on gloo ranks on the CPU:

- ``Evaluator(mesh=)`` (the corpus row-sharded over ``model``, queries over
  ``data``) against JAX's mesh ``Evaluator`` (``make_sharded_eval_step``)
  and against the port's replicated ``Evaluator``, within 1e-6;
- ``topk_mips_sharded`` / ``topk_mips_approx_sharded`` against JAX's:
  scores rtol 1e-5 (plus 1e-5 of the largest score), ids equal outside
  ranks tied within that tolerance (ROADMAP.md, Queue 3);
- a mesh device-loop epoch (eager on the CPU) against JAX's
  ``make_sharded_epoch_fn`` over JAX's permutation, handed over;
- a mesh checkpoint restores into a one-device state and into another
  layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import torch_mesh_workers as workers
from test_torch_bridge import numpy_to_jax_state
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_jax import (
    BASE,
    LAYOUTS,
    MULTI_STEP,
    NUM_ITEMS,
    NUM_USERS,
    assert_state_close,
    batches,
    jax_config,
    jax_mesh,
    jax_start,
    layout_id,
)
from torch_mesh_ranks import flatten, run_ranks
from twotower_tpu.evaluation import Evaluator as JaxEvaluator
from twotower_tpu.ops.topk import topk_mips_approx_sharded, topk_mips_sharded
from twotower_tpu.parallel.spmd import make_sharded_epoch_fn
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.evaluation import Evaluator

EVAL_ROWS, EVAL_BATCH, K = 150, 64, 20


def _eval_spec(layout, overrides=None):
    over = {**(overrides or {}), "retrieval.top_k_eval": [5, 10, 20]}
    cfg = jax_config(over, layout)
    start = jax_start(cfg, sparse=cfg.training.effective_sparse_updates())
    rng = np.random.default_rng(9)
    users = rng.integers(0, NUM_USERS, EVAL_ROWS).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, EVAL_ROWS).astype(np.int32)
    corpus = rng.normal(size=(203, 16)).astype(np.float32)
    corpus[7] = corpus[11]  # an exact tie
    spec = {"overrides": {**BASE, **over, "mesh.num_model": layout[1]}, "state": start,
            "num_items": NUM_ITEMS, "batch_size": EVAL_BATCH, "users": users, "items": items,
            "corpus": corpus, "query": rng.normal(size=(12, 16)).astype(np.float32), "k": K}
    return cfg, spec


def _same_topk(vals, ids, ref_vals, ref_ids):
    """Scores close; ids equal wherever the score is not tied (within the
    tolerance) with its neighbour."""
    atol = 1e-5 * np.abs(ref_vals).max()
    np.testing.assert_allclose(vals, ref_vals, rtol=1e-5, atol=atol)
    gap = np.diff(ref_vals, axis=1)
    tied = np.zeros_like(ref_vals, bool)
    tied[:, 1:] |= np.abs(gap) <= 2 * atol
    tied[:, :-1] |= np.abs(gap) <= 2 * atol
    np.testing.assert_array_equal(np.where(tied, -1, ids), np.where(tied, -1, ref_ids))


@pytest.mark.parametrize("layout", LAYOUTS, ids=layout_id)
def test_sharded_evaluator_and_searches_match_jax_and_replicated(tmp_path, layout):
    cfg, spec = _eval_spec(layout)
    got = run_ranks(workers.evaluate, layout[0] * layout[1], tmp_path, spec)
    mesh = jax_mesh(cfg, layout)
    jparams = numpy_to_jax_state(spec["state"]).params
    jm = JaxEvaluator(cfg, NUM_ITEMS, batch_size=EVAL_BATCH, mesh=mesh).evaluate(
        jparams, spec["users"], spec["items"])
    port_cfg = Config().with_overrides(spec["overrides"])
    replicated = Evaluator(port_cfg, NUM_ITEMS, batch_size=EVAL_BATCH, device="cpu").evaluate(
        bridge.params_from_numpy(spec["state"]["params"]), spec["users"], spec["items"])
    assert set(replicated) == set(jm) == {k.split("/", 1)[1] for k in got[0]
                                          if k.startswith("metrics/")}
    for r in got:  # every rank reports the same metrics
        for k, v in jm.items():
            np.testing.assert_allclose(r[f"metrics/{k}"], v, atol=1e-6, err_msg=k)
            np.testing.assert_allclose(r[f"metrics/{k}"], replicated[k], atol=1e-6, err_msg=k)
    n = len(spec["corpus"])
    for name, fn, exact in (("exact", topk_mips_sharded, True),
                            ("approx", topk_mips_approx_sharded, False)):
        from twotower_tpu_torch.parallel.spmd import corpus_shard_rows

        rows = corpus_shard_rows(n, layout[1], exact)
        padded = np.zeros((rows * layout[1], 16), np.float32)
        padded[:n] = spec["corpus"]
        vals, ids = shard_map(
            lambda q, c: fn(q, c, K, axis_name="model", num_items=n), mesh=mesh,
            in_specs=(P(), P("model", None)), out_specs=(P(), P()), check_rep=False,
        )(jnp.asarray(spec["query"]), jnp.asarray(padded))
        for r in got:
            _same_topk(r[f"{name}/vals"], r[f"{name}/ids"], np.asarray(vals), np.asarray(ids))


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)], ids=layout_id)
def test_mesh_epoch_matches_jax(tmp_path, layout):
    """One device-loop epoch of the sparse mesh step (4 steps) against JAX's
    ``make_sharded_epoch_fn``, from one state, over JAX's permutation of the
    columns: epoch-mean metrics and the state."""
    cfg = jax_config({}, layout)
    start = jax_start(cfg, sparse=True)
    rng = np.random.default_rng(2)
    n = 4 * cfg.training.batch_size
    users = rng.integers(0, NUM_USERS, n).astype(np.int32)
    items = rng.integers(0, NUM_ITEMS, n).astype(np.int32)
    mesh = jax_mesh(cfg, layout)
    opt = jax_make_optimizer(cfg.training)
    from twotower_tpu.parallel import shard_state

    state = shard_state(mesh, numpy_to_jax_state(start, opt), cfg.mesh, sparse_mesh=True)
    epoch_fn = make_sharded_epoch_fn(cfg, opt, mesh, state, 4, donate=False)
    epoch_rng = jax.random.fold_in(jax.random.PRNGKey(cfg.training.seed + 1), 0)
    cols = {"user_idx": jnp.asarray(users), "item_idx": jnp.asarray(items),
            "weight": jnp.ones(n, jnp.float32)}
    jstate, jm = epoch_fn(state, cols, epoch_rng)
    from test_torch_bridge import jax_state_to_numpy

    perm = np.asarray(jax.random.permutation(epoch_rng, n))
    spec = {"overrides": {**BASE, "mesh.num_model": layout[1]}, "state": start,
            "users": users, "items": items, "perm": perm, "num_items": NUM_ITEMS}
    got = run_ranks(workers.epoch, layout[0] * layout[1], tmp_path, spec)[0]
    for k in ("loss", "accuracy", "grad_norm"):
        np.testing.assert_allclose(got[f"metrics/{k}"], float(jm[k]), rtol=5e-5, err_msg=k)
    assert float(got["metrics/dropped_ids"]) == 0.0
    assert_state_close(got, jax_state_to_numpy(jstate), lr=cfg.training.learning_rate,
                       steps=4, **MULTI_STEP)


@pytest.mark.parametrize("save,restore", [((2, 1), (1, 2)), ((2, 2), (4, 1))],
                         ids=lambda x: layout_id(x))
def test_mesh_checkpoint_restores_on_one_device_and_another_layout(tmp_path, save, restore):
    from twotower_tpu_torch.training.state import init_train_state, make_optimizer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = jax_config({}, save)
    start = jax_start(cfg, sparse=True)
    spec = {"overrides": {**BASE, "mesh.num_model": save[1]}, "state": start,
            "batches": batches(2), "ckpt_dir": str(tmp_path / "ckpt"), "mode": "save"}
    saved = run_ranks(workers.checkpoint, save[0] * save[1], tmp_path / "s", spec)[0]
    # The single-device layout on disk: a one-device state restores it.
    port_cfg = Config().with_overrides({**BASE, "mesh.num_model": restore[1]})
    one = init_train_state(port_cfg, make_optimizer(port_cfg.training), NUM_USERS, NUM_ITEMS,
                           device="cpu")
    state, meta = CheckpointManager(tmp_path / "ckpt").restore(one)
    assert state.sharding is None and meta["epoch"] == 1
    want = {k[len("state/"):]: v for k, v in saved.items() if k.startswith("state/")}
    for k, v in flatten(bridge.state_to_numpy(state)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    spec.update(mode="restore", num_users=NUM_USERS, num_items=NUM_ITEMS,
                overrides={**BASE, "mesh.num_model": restore[1]})
    again = run_ranks(workers.checkpoint, restore[0] * restore[1], tmp_path / "r", spec)[0]
    for k, v in want.items():
        np.testing.assert_array_equal(again[f"state/{k}"], v, err_msg=k)
    rows = start["params"]["user_embedding"].shape[0]
    assert int(again["shard_rows"]) == rows // (restore[0] * restore[1])
    assert torch.is_tensor(state.params["user_embedding"])

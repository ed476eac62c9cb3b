"""The port's dense mesh step and the in-batch loss in block form
(``parallel/spmd.py``) against the JAX package's ``make_sharded_train_step``
(its dense GSPMD branch) and ``make_mesh_loss``, on gloo ranks on the CPU
and conftest's virtual devices. The dense step covers what the sparse math
does not model: adamw with weight decay, adagrad, sgd, and
``shard_embeddings=false``. Tolerances are the JAX tests' (see
``test_torch_sparse_mesh.py``); the loss block is held to rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_jax import (
    BASE,
    LAYOUTS,
    MULTI_STEP,
    NUM_ITEMS,
    assert_metrics_close,
    assert_state_close,
    batches,
    jax_config,
    jax_mesh,
    jax_mesh_steps,
    jax_negatives,
    jax_start,
    layout_id,
    log_q_for,
)
from torch_mesh_ranks import run_ranks

ADAMW = {"training.optimizer": "adamw", "training.weight_decay": 0.01}


def _run(tmp_path, overrides, layout, n_steps, *, tokens=None):
    cfg = jax_config(overrides, layout)
    start = jax_start(cfg, sparse=False)
    log_q = log_q_for(start["params"]["item_embedding"].shape[0])
    bl = batches(n_steps)
    jm, jstate = jax_mesh_steps(cfg, layout, start, bl, log_q=log_q, sparse=False,
                                item_tokens=tokens, num_items=NUM_ITEMS)
    spec = {"overrides": {**BASE, **overrides, "mesh.num_model": layout[1]}, "state": start,
            "batches": bl, "log_q": log_q, "num_items": NUM_ITEMS, "item_tokens": tokens,
            "neg_ids": jax_negatives(cfg, n_steps, 7)}
    got = run_ranks(workers.train_steps, layout[0] * layout[1], tmp_path, spec)[0]
    return got, jm, jstate, cfg


@pytest.mark.parametrize("layout", LAYOUTS, ids=layout_id)
def test_adamw_weight_decay_matches_jax(tmp_path, layout):
    got, jm, jstate, cfg = _run(tmp_path, ADAMW, layout, 2)
    assert "state/opt_state/mu/user_embedding" in got  # the dense layout
    assert_metrics_close(got, jm[0], 0)
    assert_metrics_close(got, jm[1], 1, loss_rtol=5e-5, norm_rtol=5e-4)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=2, **MULTI_STEP)


@pytest.mark.parametrize(
    "name,overrides,layout",
    [
        ("adagrad_mixed", {"training.optimizer": "adagrad",
                           "retrieval.candidate_sampling": "mixed",
                           "retrieval.num_negatives": 6}, (2, 2)),
        ("sgd_uniform", {"training.optimizer": "sgd", "retrieval.candidate_sampling": "uniform",
                         "retrieval.num_negatives": 6, "model.l2_regularization": 0.01},
         (4, 1)),
        ("unsharded_tables", {"mesh.shard_embeddings": False}, (1, 2)),
        ("text", {**ADAMW, "model.text_buckets": 256, "model.text_tokens": 4}, (2, 2)),
    ],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_dense_variants_match_jax(tmp_path, name, overrides, layout):
    tokens = None
    if "model.text_buckets" in overrides:
        tokens = np.random.default_rng(3).integers(0, 256, (NUM_ITEMS, 4)).astype(np.int32)
    got, jm, jstate, cfg = _run(tmp_path, overrides, layout, 2, tokens=tokens)
    assert_metrics_close(got, jm[0], 0)
    assert_metrics_close(got, jm[1], 1, loss_rtol=5e-5, norm_rtol=5e-4)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=2, **MULTI_STEP)


@pytest.mark.parametrize("num_data", [2, 4])
def test_mesh_loss_matches_jax(tmp_path, num_data):
    """``make_mesh_loss`` on the plain block: the global loss, per-example
    values, accuracy, and the gradients w.r.t. every row of both
    embeddings (the column cotangents reduce-scattered to their owners),
    against JAX's ``make_mesh_loss(force_pallas=False)``."""
    from twotower_tpu.parallel.spmd import make_mesh_loss

    rng = np.random.default_rng(0)
    b, f = 32, 16
    u = rng.normal(size=(b, f)).astype(np.float32)
    v = rng.normal(size=(b, f)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    idx = rng.integers(0, 12, b).astype(np.int32)
    w = np.ones(b, np.float32)
    w[-3:] = 0.0
    log_q = np.log(rng.uniform(0.01, 1.0, 12)).astype(np.float32)
    cfg = jax_config({}, (num_data, 1))
    loss = make_mesh_loss(jax_mesh(cfg, (num_data, 1)), cfg, force_pallas=False)

    def f_loss(uu, vv):
        return loss(uu, vv, jnp.asarray(idx), temperature=0.1, log_q=jnp.asarray(log_q),
                    weights=jnp.asarray(w))

    (jl, jmetrics), (du, dv) = jax.value_and_grad(f_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u), jnp.asarray(v))
    spec = {"user_emb": u, "item_emb": v, "item_idx": idx, "weights": w, "log_q": log_q,
            "temperature": 0.1}
    got = run_ranks(workers.mesh_loss, num_data, tmp_path, spec)[0]
    np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], float(jmetrics["accuracy"]), atol=1e-6)
    np.testing.assert_allclose(got["du"], np.asarray(du), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["dv"], np.asarray(dv), rtol=1e-5, atol=1e-6)

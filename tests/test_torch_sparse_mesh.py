"""The port's sharded sparse train step (``parallel/sparse_spmd.py``) against
the JAX package's ``make_sparse_sharded_train_step``, layout for layout.

Each test runs the port on ``D*S`` gloo ranks on the CPU (``torch_mesh_ranks``)
and JAX on the first ``D*S`` of conftest's virtual devices, from one bridged
state over the same global batches (cross-shard duplicate positives and
users, zero-weight padding rows, log q), at dropout 0 and float32 compute.
Tolerances are the JAX tests' own (``tests/test_sparse_spmd.py``): after one
step loss rtol 2e-5, accuracy atol 1e-6, grad_norm rtol 1e-4, state rtol
1e-4 / atol 1e-6; after three, loss rtol 5e-5 and state rtol 5e-3 / atol
5e-4. Uniform and mixed sampling get JAX's negatives handed in.
"""

import numpy as np
import pytest

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_jax import (
    BASE,
    LAYOUTS,
    MULTI_STEP,
    NUM_ITEMS,
    ONE_STEP,
    assert_metrics_close,
    assert_state_close,
    batches,
    jax_config,
    jax_mesh_steps,
    jax_negatives,
    jax_start,
    layout_id,
    log_q_for,
)
from torch_mesh_ranks import run_ranks


def _run(tmp_path, overrides, layout, n_steps, *, tokens=None, seed=1):
    """JAX's and the port's steps from one start: (port rank 0's flat
    result, JAX metrics, JAX final state, config)."""
    over = dict(overrides)
    cfg = jax_config(over, layout)
    start = jax_start(cfg, sparse=True)
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = log_q_for(rows_i)
    bl = batches(n_steps, seed=seed, batch=cfg.training.batch_size)
    negs = jax_negatives(cfg, n_steps, 7)
    jm, jstate = jax_mesh_steps(cfg, layout, start, bl, log_q=log_q, item_tokens=tokens,
                                num_items=NUM_ITEMS)
    spec = {"overrides": {**BASE, **over, "mesh.num_model": layout[1]},
            "state": start, "batches": bl, "log_q": log_q, "num_items": NUM_ITEMS,
            "neg_ids": negs, "item_tokens": tokens}
    got = run_ranks(workers.train_steps, layout[0] * layout[1], tmp_path, spec)[0]
    return got, jm, jstate, cfg


@pytest.mark.parametrize("layout", LAYOUTS, ids=layout_id)
def test_steps_match_jax_at_every_layout(tmp_path, layout):
    """One step (tight tolerances), then two more (the multi-step ones), on
    the in-batch path whose block loss is the fused kernel's."""
    got, jm, jstate, cfg = _run(tmp_path, {}, layout, 3)
    assert_metrics_close(got, jm[0], 0)
    for i in (1, 2):
        assert_metrics_close(got, jm[i], i, loss_rtol=5e-5, norm_rtol=5e-4)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=3, **MULTI_STEP)


@pytest.mark.parametrize("layout", [(2, 2), (1, 2)], ids=layout_id)
def test_one_step_state_matches_jax(tmp_path, layout):
    got, jm, jstate, cfg = _run(tmp_path, {}, layout, 1)
    assert_metrics_close(got, jm[0], 0)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=1, **ONE_STEP)


@pytest.mark.parametrize(
    "name,overrides,layout",
    [
        ("shard_local_negatives", {"retrieval.shard_local_negatives": True}, (2, 2)),
        ("uniform", {"retrieval.candidate_sampling": "uniform",
                     "retrieval.num_negatives": 10}, (2, 2)),
        ("mixed", {"retrieval.candidate_sampling": "mixed",
                   "retrieval.num_negatives": 10}, (1, 4)),
        ("mixed_local", {"retrieval.candidate_sampling": "mixed", "retrieval.num_negatives": 8,
                         "retrieval.shard_local_negatives": True}, (2, 2)),
        ("l2", {"model.l2_regularization": 0.01}, (4, 1)),
    ],
    ids=lambda x: x if isinstance(x, str) else None,
)
def test_variants_match_jax(tmp_path, name, overrides, layout):
    got, jm, jstate, cfg = _run(tmp_path, overrides, layout, 2)
    assert_metrics_close(got, jm[0], 0)
    assert_metrics_close(got, jm[1], 1, loss_rtol=5e-5, norm_rtol=5e-4)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=2, **MULTI_STEP)


@pytest.mark.parametrize("sampling", ["in_batch", "mixed"])
def test_text_tower_matches_jax(tmp_path, sampling):
    over = {"model.text_buckets": 256, "model.text_tokens": 4,
            "retrieval.candidate_sampling": sampling, "retrieval.num_negatives": 6}
    tokens = np.random.default_rng(3).integers(0, 256, (NUM_ITEMS, 4)).astype(np.int32)
    tokens[:, -1] = 0  # PAD
    got, jm, jstate, cfg = _run(tmp_path, over, (2, 2) if sampling == "mixed" else (1, 2), 2,
                                tokens=tokens)
    assert "state/table_state/text_embedding/moments" in got
    assert_metrics_close(got, jm[0], 0)
    assert_state_close(got, jstate, lr=cfg.training.learning_rate, steps=2, **MULTI_STEP)


def test_bfloat16_dense_grads_track_float32(tmp_path):
    """``mesh.dense_grad_dtype=bfloat16`` (JAX ``TestBf16DenseGradPsum``): the
    port in bf16 against JAX in bf16, and against the port in f32 as JAX
    holds its own: loss within 1e-6, tables within 1e-6 (they do not ride
    the dense all-reduce), tower kernels within the Adam step."""
    got16, jm16, jst16, cfg = _run(tmp_path / "b", {"mesh.dense_grad_dtype": "bfloat16"},
                                   (2, 2), 1)
    got32, _, _, _ = _run(tmp_path / "f", {}, (2, 2), 1)
    assert_metrics_close(got16, jm16[0], 0)
    np.testing.assert_allclose(got16["metrics/0/loss"], got32["metrics/0/loss"], rtol=1e-6)
    np.testing.assert_allclose(got16["state/params/item_embedding"],
                               got32["state/params/item_embedding"], rtol=1e-6, atol=1e-7)
    lr = cfg.training.learning_rate

    def tracks(k16, k32):
        # bf16 rounding of a gradient can flip the sign of an Adam step on
        # a near-zero element: the bulk strictly close, all within the step.
        diff = np.abs(k16 - k32)
        assert (diff <= 2e-4 + 1e-2 * np.abs(k32)).mean() >= 0.9
        assert diff.max() <= 2.2 * lr

    tracks(got16["state/params/user_tower/0/kernel"], got32["state/params/user_tower/0/kernel"])
    # Against JAX in bf16 (its sums in bf16 run in another order): the
    # tables and their moments tight, the tower kernels as bf16 tracks f32.
    for t in ("user_embedding", "item_embedding"):
        assert_state_close(got16, {"params": {t: jst16["params"][t]},
                                   "table_state": {t: jst16["table_state"][t]}},
                           lr=lr, steps=1, **ONE_STEP)
    for tower in ("user_tower", "item_tower"):
        for i, layer in enumerate(jst16["params"][tower]):
            tracks(got16[f"state/params/{tower}/{i}/kernel"], layer["kernel"])


def test_tight_capacity_drops_as_jax_and_factor_two_drops_none(tmp_path):
    """Distinct item ids all on one owner with ``a2a_capacity_factor=1.0``
    overflow the buckets: the port counts the same ``dropped_ids`` as JAX.
    At factor 2.0 on uniform ids nothing drops."""
    over = {"mesh.a2a_capacity_factor": 1.0}
    cfg = jax_config({**over, "training.batch_size": 128}, (2, 2))
    start = jax_start(cfg, sparse=True)
    b = batches(1, batch=128)[0]
    b["item_idx"] = (np.arange(128) % 32).astype(np.int32)
    jm, _ = jax_mesh_steps(cfg, (2, 2), start, [b])
    assert jm[0]["dropped_ids"] > 0
    spec = {"overrides": {**BASE, **over, "training.batch_size": 128,
                          "mesh.num_model": 2},
            "state": start, "batches": [b]}
    got = run_ranks(workers.train_steps, 4, tmp_path / "tight", spec)[0]
    assert float(got["metrics/0/dropped_ids"]) == jm[0]["dropped_ids"]
    spec["overrides"]["mesh.a2a_capacity_factor"] = 2.0
    spec["batches"] = batches(2, batch=128, seed=4)
    got = run_ranks(workers.train_steps, 4, tmp_path / "two", spec)[0]
    assert float(got["metrics/0/dropped_ids"]) == float(got["metrics/1/dropped_ids"]) == 0.0

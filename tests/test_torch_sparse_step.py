"""The port's sparse train step against the JAX package's
``make_train_step``: three steps from one bridged state at dropout 0, with
host dedup on and off, compared in params, table moments, dense Adam state,
loss and grad_norm.

Compute is float32 here (the point is the algorithm; bf16 rounding is held
by test_torch_two_tower.py). Both sides then do the same float32 arithmetic
up to summation order; Adam divides each gradient by its own running norm,
so a relative error of ~1e-6 in a gradient moves an update of size lr=1e-3
by ~1e-9, and three steps stay well inside rtol 1e-4 / atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import jax_sparse_state, jax_state_to_numpy
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.training import sparse as jax_sparse
from twotower_tpu.training.host_dedup import augment_batch as jax_augment_batch
from twotower_tpu.training.loop import make_train_step as jax_make_train_step
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import make_optimizer, make_train_step, sparse
from twotower_tpu_torch.training.host_dedup import augment_batch
from twotower_tpu_torch.training.state import lr_at
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)

NUM_USERS, NUM_ITEMS, BATCH = 1000, 500, 256
OVERRIDES = {
    "model.embedding_dim": 32,
    "model.user_tower_dims": [64, 32],
    "model.item_tower_dims": [64, 32],
    "model.dropout_rate": 0.0,
    "model.compute_dtype": "float32",
    "training.batch_size": BATCH,
}
TOL = dict(rtol=1e-4, atol=1e-6)


def _batches(n, dead_u, dead_i, host_dedup):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        b = {
            "user_idx": rng.integers(0, NUM_USERS, BATCH).astype(np.int32),
            # 500 items at batch 256: many duplicate item ids per batch.
            "item_idx": rng.integers(0, NUM_ITEMS, BATCH).astype(np.int32),
            "weight": np.ones(BATCH, np.float32),
        }
        b["weight"][-5:] = 0.0
        if host_dedup:
            b = jax_augment_batch(b, user_dead=dead_u, item_dead=dead_i)
        out.append(b)
    return out


@pytest.mark.parametrize("host_dedup", [False, True])
def test_three_steps_match_jax(host_dedup):
    jcfg = JaxConfig().with_overrides(OVERRIDES)
    cfg = Config().with_overrides(OVERRIDES)
    jstate = jax_sparse_state(jcfg, NUM_USERS, NUM_ITEMS, seed=0)
    start = jax_state_to_numpy(jstate)
    log_q = np.log(
        np.random.default_rng(12).dirichlet(np.ones(start["params"]["item_embedding"].shape[0]))
        + 1e-9
    ).astype(np.float32)
    batches = _batches(
        3,
        start["params"]["user_embedding"].shape[0] - 1,
        start["params"]["item_embedding"].shape[0] - 1,
        host_dedup,
    )

    jstep = jax_make_train_step(jcfg, jax_make_optimizer(jcfg.training), jnp.asarray(log_q))
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jax_end = jax_state_to_numpy(jstate)

    state = bridge.state_from_numpy(start, device="cpu")
    step = make_train_step(cfg, make_optimizer(cfg.training), log_q, device="cpu")
    for b, jm in zip(batches, jmetrics):
        state, m = step(state, b, None)
        for key in ("loss", "grad_norm", "accuracy", "logits_mean"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5, atol=1e-6, err_msg=key)
    end = bridge.state_to_numpy(state)

    assert end["step"] == jax_end["step"] == 3
    assert end["opt_state"]["count"] == jax_end["opt_state"]["count"] == 3
    for part in ("params", "table_state", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(end[part])
        lb, tb = jax.tree_util.tree_flatten(jax_end[part])
        assert ta == tb, part
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL, err_msg=part)


def test_host_dedup_copy_matches_jax():
    ids = np.random.default_rng(0).integers(0, 50, 64).astype(np.int32)
    b = {"user_idx": ids, "item_idx": ids[::-1].copy()}
    ours = augment_batch(b, user_dead=127, item_dead=63)
    ref = jax_augment_batch(b, user_dead=127, item_dead=63)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], ref[k])


def test_dedup_rows_matches_jax():
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 20, 64).astype(np.int32)
    grads = rng.normal(size=(64, 8)).astype(np.float32)
    jt, js, jv = jax_sparse.dedup_rows(jnp.asarray(ids), jnp.asarray(grads), 99)
    tt, ts, tv = sparse.dedup_rows(torch.from_numpy(ids), torch.from_numpy(grads), 99)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def test_adam_row_update_packed_matches_jax():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(32, 4)).astype(np.float32)
    moments = np.abs(rng.normal(size=(32, 8))).astype(np.float32)
    targets = np.array([3, 5, 9, 31, 31], np.int32)  # 31: the dead row
    valid = np.array([True, True, True, False, False])
    grads = rng.normal(size=(5, 4)).astype(np.float32)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    jt, jm = jax_sparse.adam_row_update_packed(
        jnp.asarray(table), jnp.asarray(moments), jnp.asarray(targets),
        jnp.asarray(grads), jnp.asarray(valid), step=jnp.asarray(4), **kw,
    )
    tt, tm = torch.from_numpy(table.copy()), torch.from_numpy(moments.copy())
    sparse.adam_row_update_packed(
        tt, tm, torch.from_numpy(targets), torch.from_numpy(grads),
        torch.from_numpy(valid), step=4, **kw,
    )
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup,decay", [(10, 0), (10, 100), (0, 50), (0, 0)])
def test_lr_schedule_matches_optax(warmup, decay):
    """Also the device twin ``lr_at`` (the device loop's, float32 like
    optax's) at a 0-d float32 count."""
    over = {"training.warmup_steps": warmup, "training.decay_steps": decay}
    cfg = Config().with_overrides(over).training
    ours = sparse.make_lr_fn(cfg)
    ref = jax_sparse.make_lr_fn(JaxConfig().with_overrides(over).training)
    # optax evaluates in float32, the port in float64: rtol 1e-5.
    for count in (0, 1, 5, 10, 11, 60, 109, 110, 500):
        np.testing.assert_allclose(ours(count), float(ref(count)), rtol=1e-5, atol=1e-12)
        dev = lr_at(cfg, torch.tensor(float(count)))
        assert dev.dtype == torch.float32 and dev.dim() == 0
        np.testing.assert_allclose(float(dev), float(ref(count)), rtol=1e-6, atol=1e-12)


def test_unported_paths_raise():
    cfg = Config().with_overrides(OVERRIDES)
    opt = make_optimizer(cfg.training)
    # Another optimizer or weight decay leaves the sparse path for the dense
    # step, which is not ported (uniform and mixed sampling are: see
    # test_torch_sampling.py).
    for over in ({"training.optimizer": "adagrad"}, {"training.weight_decay": 0.01}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_train_step(cfg.with_overrides(over), opt, device="cpu", num_items=NUM_ITEMS)
    with pytest.raises(NotImplementedError, match="dense train step"):
        make_train_step(cfg.with_overrides({"training.sparse_table_updates": False}), opt,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer(cfg.with_overrides({"training.optimizer": "sgd"}).training)


def test_optax_adam_state_layout_is_what_the_bridge_reads():
    """The JAX sparse state's dense optimizer is optax.adam at a constant
    lr: (ScaleByAdamState, EmptyState) — the layout the bridge converts."""
    jstate = jax_sparse_state(JaxConfig().with_overrides(OVERRIDES), 10, 10)
    assert isinstance(jstate.opt_state[0], optax.ScaleByAdamState)
    assert isinstance(jstate.opt_state[1], optax.EmptyState)

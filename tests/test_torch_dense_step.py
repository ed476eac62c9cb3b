"""The port's dense train step (``training/loop.py::make_step_fn``: the
whole parameter tree differentiated, the optimizer over every leaf) against
the JAX package's ``make_step_fn``, on the CPU.

- Three steps from one bridged state at dropout 0, float32 compute, with
  each optimizer (adam with ``sparse_table_updates=false``, adamw, adagrad,
  sgd, adam with weight decay, one under warmup + cosine decay) in_batch,
  and adam with uniform and mixed sampling (JAX's threefry negative ids
  handed in): loss and metrics rtol 1e-5 / atol 1e-6, the state rtol 1e-4 /
  atol 1e-5 (``test_torch_sparse_step.py``'s tolerances).
- The first sparse step equals the first dense step from one state, and
  three steps on one batch agree (JAX ``tests/test_sparse.py:77-115``).
- Two dense device-loop epochs against JAX's ``make_epoch_fn`` with JAX's
  permutation handed over, and ``Trainer.fit`` on the dense path against
  JAX's ``Trainer.fit``.
- The host dedup stays off on the dense path, and the rungs' state estimate
  equals JAX's for the dense layouts and the text table.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_device_loop import STATE_TOL as EPOCH_TOL
from test_torch_device_loop import _two_epochs
from test_torch_trainer import _jax_fit, _port_fit
from test_torch_trainer import _setup as trainer_setup
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.training import rungs as jax_rungs
from twotower_tpu.training.host_dedup import wants_host_dedup as jax_wants_host_dedup
from twotower_tpu.training.loop import make_train_step as jax_make_train_step
from twotower_tpu.training.state import TrainState as JaxTrainState
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step
from twotower_tpu_torch.training import rungs
from twotower_tpu_torch.training.host_dedup import wants_host_dedup
from twotower_tpu_torch.training.loop import make_step_fn
from twotower_tpu_torch.training.sparse import make_sparse_step_fn

NUM_USERS, NUM_ITEMS, BATCH, NEGS = 1000, 500, 256, 64
OVERRIDES = {
    "model.embedding_dim": 32,
    "model.user_tower_dims": [64, 32],
    "model.item_tower_dims": [64, 32],
    "model.dropout_rate": 0.0,
    "model.compute_dtype": "float32",
    "training.batch_size": BATCH,
    "retrieval.num_negatives": NEGS,
}
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
DENSE = {"training.sparse_table_updates": False}
# Each optimizer that leaves the sparse path.
OPTIMIZERS = {
    "adam_dense": DENSE,
    "adamw": {"training.optimizer": "adamw", "training.weight_decay": 0.01},
    "adagrad": {"training.optimizer": "adagrad"},
    "sgd": {"training.optimizer": "sgd", "training.learning_rate": 0.05},
    "adam_decay": {"training.weight_decay": 0.01},
    "adamw_schedule": {"training.optimizer": "adamw", "training.weight_decay": 0.01,
                       "training.warmup_steps": 2, "training.decay_steps": 5},
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_neg_ids(step: int) -> np.ndarray:
    """The JAX dense step's draw (``training/loop.py``): ``fold_in(fold_in(
    rng, step), 0x5E9)`` with the tests' rng ``PRNGKey(1)``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), step), 0x5E9)
    return np.asarray(jax.random.randint(key, (NEGS,), 0, NUM_ITEMS, dtype=jnp.int32))


def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {
            "user_idx": rng.integers(0, NUM_USERS, BATCH).astype(np.int32),
            # 500 items at batch 256: many duplicate item ids per batch.
            "item_idx": rng.integers(0, NUM_ITEMS, BATCH).astype(np.int32),
            "weight": np.ones(BATCH, np.float32),
        }
        b["weight"][-5:] = 0.0
        out.append(b)
    return out


def _jax_dense_state(jcfg, seed=0):
    params = jtt.init_params(jax.random.PRNGKey(seed), jcfg.model, NUM_USERS, NUM_ITEMS)
    state = JaxTrainState.for_config(params, jax_make_optimizer(jcfg.training), jcfg)
    assert state.table_state is None
    return state


def _record_cancelled(opt):
    """Mark, per parameter, the elements whose gradient fed to the optimizer
    (after coupled weight decay) was non-zero but under 1e-6 in some step.
    There Adam's ``m / (sqrt(v) + eps)`` (eps 1e-8) is decided by the
    gradient's last float32 bits, which the two frameworks' summation orders
    set differently: such an element's update can differ by up to lr a
    step. (With adam and weight decay 0.01, ``g + wd * p`` cancels to
    1.7e-8 at one tower weight here.) Returns {data_ptr: bool mask}."""
    masks = {}
    coupled = opt._coupled

    def record(g, p):
        g = coupled(g, p)
        small = (g.abs() < 1e-6) & (g != 0)
        masks[p.data_ptr()] = masks.get(p.data_ptr(), torch.zeros_like(small)) | small
        return g

    opt._coupled = record
    return masks


def _assert_states_close(end, ref, tol, params=None, cancelled=None, lr_steps=0.0):
    """State parts within ``tol``; with ``cancelled`` (``_record_cancelled``)
    the masked elements of ``params`` within ``lr_steps`` absolute."""
    masks = [None] * len(jax.tree_util.tree_leaves(end["params"]))
    if cancelled:
        masks = [cancelled.get(t.data_ptr()) for t in jax.tree_util.tree_leaves(params)]
    for part in ("params", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(end[part])
        lb, tb = jax.tree_util.tree_flatten(ref[part])
        assert ta == tb, part
        for i, (x, y) in enumerate(zip(la, lb)):
            x, y = np.asarray(x), np.asarray(y)
            mask = masks[i] if part == "params" else None
            if mask is not None and mask.any():
                mask = mask.numpy()
                np.testing.assert_allclose(x[mask], y[mask], rtol=0, atol=lr_steps)
                x, y = x[~mask], y[~mask]
            np.testing.assert_allclose(x, y, **tol, err_msg=part)


@pytest.mark.parametrize("opt,mode", [
    *((name, "in_batch") for name in OPTIMIZERS),
    ("adam_dense", "uniform"), ("adam_dense", "mixed"),
])
def test_three_dense_steps_match_jax(opt, mode):
    over = {**OVERRIDES, **OPTIMIZERS[opt], "retrieval.candidate_sampling": mode}
    jcfg, cfg = JaxConfig().with_overrides(over), Config().with_overrides(over)
    assert not cfg.training.effective_sparse_updates()
    jstate = _jax_dense_state(jcfg)
    start = jax_state_to_numpy(jstate)
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = np.log(np.random.default_rng(12).dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
    batches = _batches(3)

    jstep = jax_make_train_step(jcfg, jax_make_optimizer(jcfg.training), jnp.asarray(log_q),
                                num_items=NUM_ITEMS)
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jax_end = jax_state_to_numpy(jstate)

    state = bridge.state_from_numpy(start, device="cpu")
    opt_ = make_optimizer(cfg.training)
    cancelled = _record_cancelled(opt_)
    if mode == "in_batch":  # the user's entry point
        step = make_train_step(cfg, opt_, log_q, num_items=NUM_ITEMS, device="cpu")
        run = lambda st, b, i: step(st, b, None)  # noqa: E731
    else:  # the raw step, handed JAX's negatives
        raw = make_step_fn(cfg, opt_, num_items=NUM_ITEMS)
        run = lambda st, b, i: raw(  # noqa: E731
            st, {k: _t(v) for k, v in b.items()}, None, _t(log_q), neg_ids=_t(_jax_neg_ids(i)))
    for i, (b, jm) in enumerate(zip(batches, jmetrics)):
        state, m = run(state, b, i)
        assert sorted(m) == sorted(jm)
        for key in jm:
            np.testing.assert_allclose(float(m[key]), jm[key], **LOSS_TOL, err_msg=key)
    end = bridge.state_to_numpy(state)
    assert end["step"] == jax_end["step"] == 3 and end["table_state"] is None
    assert end["opt_state"]["count"] == jax_end["opt_state"]["count"] == 3
    _assert_states_close(end, jax_end, TOL, state.params, cancelled,
                         3 * cfg.training.learning_rate)


def _sparse_and_dense(over=None):
    over = {**OVERRIDES, **(over or {})}
    cfg_s = Config().with_overrides(over)
    cfg_d = cfg_s.with_overrides(DENSE)
    opt_s, opt_d = make_optimizer(cfg_s.training), make_optimizer(cfg_d.training)
    state_s = init_train_state(cfg_s, opt_s, NUM_USERS, NUM_ITEMS, device="cpu")
    state_d = init_train_state(cfg_d, opt_d, NUM_USERS, NUM_ITEMS, device="cpu")
    assert state_s.table_state is not None and state_d.table_state is None
    return (make_sparse_step_fn(cfg_s, opt_s), state_s), (make_step_fn(cfg_d, opt_d), state_d)


def test_first_sparse_step_equals_dense_step():
    """Lazy Adam is dense Adam on the first step: the untouched rows' dense
    update is 0 / (0 + eps)."""
    (sparse_step, state_s), (dense_step, state_d) = _sparse_and_dense()
    batch = {k: _t(v) for k, v in _batches(1)[0].items()}
    before = bridge.params_to_numpy(state_d.params)
    state_s, m_s = sparse_step(state_s, batch, None)
    state_d, m_d = dense_step(state_d, batch, None)
    np.testing.assert_allclose(float(m_s["loss"]), float(m_d["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_s["grad_norm"]), float(m_d["grad_norm"]), rtol=1e-5)
    ps, pd = bridge.params_to_numpy(state_s.params), bridge.params_to_numpy(state_d.params)
    np.testing.assert_allclose(ps["user_tower"][0]["kernel"], pd["user_tower"][0]["kernel"],
                               rtol=1e-5, atol=1e-7)
    for table in ("user_embedding", "item_embedding"):
        np.testing.assert_allclose(ps[table], pd[table], rtol=1e-4, atol=1e-6)
    untouched = np.setdiff1d(np.arange(NUM_USERS), batch["user_idx"].numpy())
    np.testing.assert_array_equal(pd["user_embedding"][untouched],
                                  before["user_embedding"][untouched])


def test_multi_step_same_batch_matches_dense():
    """The same rows touched every step: lazy Adam = dense Adam."""
    (sparse_step, state_s), (dense_step, state_d) = _sparse_and_dense()
    batch = {k: _t(v) for k, v in _batches(1)[0].items()}
    for _ in range(3):
        state_s, _ = sparse_step(state_s, batch, None)
        state_d, _ = dense_step(state_d, batch, None)
    np.testing.assert_allclose(state_s.params["item_embedding"].numpy(),
                               state_d.params["item_embedding"].numpy(), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("opt", ["adam_dense", "adagrad", "adamw_schedule"])
def test_dense_device_loop_epochs_match_jax(opt):
    state, jstate, losses = _two_epochs(OPTIMIZERS[opt])
    for ours, ref in losses:
        np.testing.assert_allclose(ours, ref, rtol=1e-4)
    ours, ref = bridge.state_to_numpy(state), jax_state_to_numpy(jstate)
    assert ours["table_state"] is None and ours["step"] == ref["step"] > 0
    assert ours["opt_state"]["count"] == ref["opt_state"]["count"] == ours["step"]
    _assert_states_close(ours, ref, EPOCH_TOL)


def test_trainer_fit_dense_matches_jax():
    """``Trainer.fit`` with adamw and weight decay (two epochs, validation
    each epoch) against JAX's from one state: the dense path, no host
    dedup."""
    cfg, jcfg, pp, splits = trainer_setup(OPTIMIZERS["adamw"])
    jres, start = _jax_fit(jcfg, pp, splits)
    assert start["table_state"] is None
    res = _port_fit(cfg, pp, splits, start)
    flip = 1.0 / len(splits.val)
    for ours, ref in zip(res.history, jres.history, strict=True):
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
        assert abs(ours["val/recall@10"] - ref["val/recall@10"]) <= flip
    _assert_states_close(bridge.state_to_numpy(res.state), jax_state_to_numpy(jres.state),
                         EPOCH_TOL)


@pytest.mark.parametrize("over", [{}, DENSE, OPTIMIZERS["adagrad"]])
def test_host_dedup_only_on_the_sparse_path(over):
    cfg = Config().with_overrides({**OVERRIDES, **over})
    jcfg = JaxConfig().with_overrides({**OVERRIDES, **over})
    assert wants_host_dedup(cfg, None) == jax_wants_host_dedup(jcfg, None) == (not over)


@pytest.mark.parametrize("over", [
    {}, DENSE, OPTIMIZERS["adagrad"], {"model.text_buckets": 65536},
    {**DENSE, "model.text_buckets": 1000, "model.text_tokens": 8},
])
def test_rung_state_bytes_match_jax(over):
    cfg = Config().with_overrides({**OVERRIDES, **over})
    jcfg = JaxConfig().with_overrides({**OVERRIDES, **over})
    assert (rungs.train_state_bytes(cfg, 1_000_000, 500_000)
            == jax_rungs.train_state_bytes(jcfg, 1_000_000, 500_000))

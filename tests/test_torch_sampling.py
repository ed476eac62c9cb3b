"""Uniform and mixed candidate sampling in the PyTorch port, against the JAX
package: the four loss functions, three sparse steps of each mode from one
bridged state at dropout 0 (the port handed JAX's threefry negative ids,
``fold_in(fold_in(rng, step), 0x5E9)``), and a ``mixed`` device-loop epoch
on the CPU against the same steps run one by one.

Compute is float32; tolerances as in test_torch_sparse_step.py: losses and
metrics rtol 1e-5, state after three steps rtol 1e-4 / atol 1e-5 (Adam
turns a relative error of 1e-6 in a near-zero gradient element into an
update difference of that size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_sparse_state, jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.ops import losses as jax_losses
from twotower_tpu.training.host_dedup import augment_batch as jax_augment_batch
from twotower_tpu.training.loop import make_train_step as jax_make_train_step
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.ops import losses
from twotower_tpu_torch.training import make_optimizer
from twotower_tpu_torch.training import sparse

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


def _t(x):
    return torch.from_numpy(np.array(x))


def _loss_inputs(seed=0, rows=48, batch=48, negs=16, dim=8, items=30):
    """Unit-norm rows; item ids from a small range (accidental hits among
    the in-batch columns) and negatives that include some rows' positives
    (accidental hits in the uniform block); five zero-weight rows."""
    rng = np.random.default_rng(seed)

    def unit(n):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    item_idx = rng.integers(0, items, batch).astype(np.int32)
    neg_idx = rng.integers(0, items, negs).astype(np.int32)
    neg_idx[:3] = item_idx[:3]  # planted hits in the uniform block
    weights = np.ones(batch, np.float32)
    weights[-5:] = 0.0
    log_q = np.log(rng.dirichlet(np.ones(items)) + 1e-9).astype(np.float32)
    return dict(u=unit(rows), v=unit(batch), neg=unit(negs), item_idx=item_idx,
                neg_idx=neg_idx, weights=weights, log_q=log_q, items=items)


def _close(ours, ref, tol=LOSS_TOL):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **tol)


@pytest.mark.parametrize("logq", [False, True])
@pytest.mark.parametrize("offset,rows", [(0, 48), (16, 20)])
def test_mixed_softmax_block_matches_jax(logq, offset, rows):
    x = _loss_inputs(seed=offset + rows)
    u = x["u"][offset : offset + rows]
    kw = dict(temperature=0.1, weights_all=x["weights"])
    lq = x["log_q"] if logq else None
    lu = -np.log(x["items"]) if logq else None
    ref = jax_losses.mixed_softmax_block(
        jnp.asarray(u), jnp.asarray(x["v"]), jnp.asarray(x["item_idx"]), offset,
        jnp.asarray(x["neg"]), jnp.asarray(x["neg_idx"]),
        log_q=None if lq is None else jnp.asarray(lq), log_uniform=lu,
        **{k: jnp.asarray(v) if k == "weights_all" else v for k, v in kw.items()},
    )
    got = losses.mixed_softmax_block(
        _t(u), _t(x["v"]), _t(x["item_idx"]), offset, _t(x["neg"]), _t(x["neg_idx"]),
        log_q=None if lq is None else _t(lq), log_uniform=lu,
        **{k: _t(v) if k == "weights_all" else v for k, v in kw.items()},
    )
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("logq", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_mixed_sampled_softmax_loss_and_grads_match_jax(logq, weighted):
    x = _loss_inputs(seed=3)
    lq = x["log_q"] if logq else None
    w = x["weights"] if weighted else None

    def jloss(u, v, neg):
        return jax_losses.mixed_sampled_softmax_loss(
            u, v, jnp.asarray(x["item_idx"]), neg, jnp.asarray(x["neg_idx"]), temperature=0.1,
            log_q=None if lq is None else jnp.asarray(lq), num_items=x["items"],
            weights=None if w is None else jnp.asarray(w),
        )

    (jl, jm), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["u"]), jnp.asarray(x["v"]), jnp.asarray(x["neg"]))
    tu, tv, tn = (_t(x[k]).requires_grad_() for k in ("u", "v", "neg"))
    tl, tm = losses.mixed_sampled_softmax_loss(
        tu, tv, _t(x["item_idx"]), tn, _t(x["neg_idx"]), temperature=0.1,
        log_q=None if lq is None else _t(lq), num_items=x["items"],
        weights=None if w is None else _t(w),
    )
    tl.backward()
    _close(tl.item(), jl)
    for k in ("accuracy", "logits_mean"):
        _close(tm[k].item(), jm[k])
    for a, b in zip((tu.grad, tv.grad, tn.grad), jg):
        _close(a.numpy(), b, dict(rtol=1e-5, atol=1e-7))


@pytest.mark.parametrize("masked", [False, True])
def test_uniform_softmax_block_matches_jax(masked):
    x = _loss_inputs(seed=5)
    ids = (x["item_idx"], x["neg_idx"]) if masked else (None, None)
    ref = jax_losses.uniform_softmax_block(
        jnp.asarray(x["u"]), jnp.asarray(x["v"]), jnp.asarray(x["neg"]),
        *(None if i is None else jnp.asarray(i) for i in ids), temperature=0.1,
    )
    got = losses.uniform_softmax_block(
        _t(x["u"]), _t(x["v"]), _t(x["neg"]), *(None if i is None else _t(i) for i in ids),
        temperature=0.1,
    )
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


@pytest.mark.parametrize("weighted", [False, True])
def test_uniform_sampled_softmax_loss_and_grads_match_jax(weighted):
    x = _loss_inputs(seed=6)
    w = x["weights"] if weighted else None

    def jloss(u, v, neg):
        return jax_losses.uniform_sampled_softmax_loss(
            u, v, neg, temperature=0.1, weights=None if w is None else jnp.asarray(w),
            pos_idx=jnp.asarray(x["item_idx"]), neg_idx=jnp.asarray(x["neg_idx"]),
        )

    (jl, jm), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x["u"]), jnp.asarray(x["v"]), jnp.asarray(x["neg"]))
    tu, tv, tn = (_t(x[k]).requires_grad_() for k in ("u", "v", "neg"))
    tl, tm = losses.uniform_sampled_softmax_loss(
        tu, tv, tn, temperature=0.1, weights=None if w is None else _t(w),
        pos_idx=_t(x["item_idx"]), neg_idx=_t(x["neg_idx"]),
    )
    tl.backward()
    _close(tl.item(), jl)
    for k in ("accuracy", "logits_mean"):
        _close(tm[k].item(), jm[k])
    for a, b in zip((tu.grad, tv.grad, tn.grad), jg):
        _close(a.numpy(), b, dict(rtol=1e-5, atol=1e-7))


def test_sampled_losses_raise_as_jax_does():
    x = _loss_inputs()
    args = (_t(x["u"]), _t(x["v"]), _t(x["item_idx"]))
    with pytest.raises(ValueError, match="log_uniform"):
        losses.mixed_softmax_block(*args, 0, _t(x["neg"]), _t(x["neg_idx"]),
                                   log_q=_t(x["log_q"]))
    with pytest.raises(ValueError, match="num_items"):
        losses.mixed_sampled_softmax_loss(*args, _t(x["neg"]), _t(x["neg_idx"]),
                                          log_q=_t(x["log_q"]))
    # Without log q neither correction applies, and no num_items is needed.
    loss, _ = losses.mixed_sampled_softmax_loss(*args, _t(x["neg"]), _t(x["neg_idx"]))
    assert torch.isfinite(loss)
    cfg = Config().with_overrides({**OVERRIDES, "retrieval.candidate_sampling": "mixed"})
    with pytest.raises(ValueError, match="needs num_items"):
        sparse.make_sparse_step_fn(cfg, make_optimizer(cfg.training))


def _jax_neg_ids(step: int) -> np.ndarray:
    """The JAX step's draw (``training/sparse.py``): ``fold_in(fold_in(rng,
    step), 0x5E9)``, with the tests' rng ``PRNGKey(1)``."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), step), 0x5E9)
    return np.asarray(jax.random.randint(key, (NEGS,), 0, NUM_ITEMS, dtype=jnp.int32))


def _batches(n, dead_u, dead_i, host_dedup):
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        b = {
            "user_idx": rng.integers(0, NUM_USERS, BATCH).astype(np.int32),
            "item_idx": rng.integers(0, NUM_ITEMS, BATCH).astype(np.int32),
            "weight": np.ones(BATCH, np.float32),
        }
        b["weight"][-5:] = 0.0
        if host_dedup:
            # Item targets too: the step must ignore them when it samples.
            b = jax_augment_batch(b, user_dead=dead_u, item_dead=dead_i)
        out.append(b)
    return out


@pytest.mark.parametrize("mode,logq,host_dedup", [
    ("uniform", True, False), ("uniform", True, True),
    ("mixed", True, False), ("mixed", True, True), ("mixed", False, False),
])
def test_three_sampled_steps_match_jax(mode, logq, host_dedup):
    over = {**OVERRIDES, "retrieval.candidate_sampling": mode,
            "retrieval.logq_correction": logq}
    jcfg = JaxConfig().with_overrides(over)
    cfg = Config().with_overrides(over)
    jstate = jax_sparse_state(jcfg, NUM_USERS, NUM_ITEMS, seed=0)
    start = jax_state_to_numpy(jstate)
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = np.log(np.random.default_rng(12).dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
    batches = _batches(3, start["params"]["user_embedding"].shape[0] - 1, rows_i - 1, host_dedup)

    jstep = jax_make_train_step(jcfg, jax_make_optimizer(jcfg.training), jnp.asarray(log_q),
                                num_items=NUM_ITEMS)
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jax_end = jax_state_to_numpy(jstate)

    state = bridge.state_from_numpy(start, device="cpu")
    step = sparse.make_sparse_step_fn(cfg, make_optimizer(cfg.training), num_items=NUM_ITEMS)
    for i, (b, jm) in enumerate(zip(batches, jmetrics)):
        state, m = step(state, {k: _t(v) for k, v in b.items()}, None, _t(log_q),
                        neg_ids=_t(_jax_neg_ids(i)))
        for key in ("loss", "grad_norm", "accuracy", "logits_mean"):
            np.testing.assert_allclose(float(m[key]), jm[key], **LOSS_TOL, err_msg=key)
    end = bridge.state_to_numpy(state)

    assert end["step"] == jax_end["step"] == 3
    for part in ("params", "table_state", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(end[part])
        lb, tb = jax.tree_util.tree_flatten(jax_end[part])
        assert ta == tb, part
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL, err_msg=part)


def _sampled_rows(before: np.ndarray, after: np.ndarray, positives: np.ndarray) -> set:
    """Item rows a step updated that were not among its positives: the
    negatives it drew (read from the table's moments)."""
    changed = np.flatnonzero((before != after).any(axis=1))
    return set(changed.tolist()) - set(np.asarray(positives).tolist())


def test_step_draws_fresh_negatives_without_an_rng():
    """At dropout 0 the step needs no rng (the device's default generator
    draws), and two steps draw different negatives."""
    from twotower_tpu_torch.training import init_train_state

    cfg = Config().with_overrides({**OVERRIDES, "retrieval.candidate_sampling": "uniform"})
    opt = make_optimizer(cfg.training)
    state = init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS, device="cpu")
    step = sparse.make_sparse_step_fn(cfg, opt, num_items=NUM_ITEMS)
    b = {k: _t(v) for k, v in _batches(1, 0, 0, False)[0].items()}
    drawn = []
    for _ in range(2):
        before = state.table_state["item_embedding"]["moments"].numpy().copy()
        state, m = step(state, b, None)
        after = state.table_state["item_embedding"]["moments"].numpy()
        drawn.append(_sampled_rows(before, after, b["item_idx"]))
        assert np.isfinite(float(m["loss"]))
    assert drawn[0] and drawn[1] and drawn[0] != drawn[1]
    assert all(r < NUM_ITEMS for r in drawn[0] | drawn[1])


def test_mixed_device_loop_epoch_matches_steps_one_by_one():
    """A ``mixed`` device-loop epoch on the CPU (the step with its clock,
    the negatives from the epoch's generator) against the same steps run
    one by one through the host-loop step with a generator of the same
    seed, from one state and one permutation."""
    from twotower_tpu_torch.training import init_train_state
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    cfg = Config().with_overrides({**OVERRIDES, "retrieval.candidate_sampling": "mixed",
                                   "training.warmup_steps": 2, "training.decay_steps": 6})
    opt = make_optimizer(cfg.training)
    start = bridge.state_to_numpy(init_train_state(cfg, opt, NUM_USERS, NUM_ITEMS, device="cpu"))
    rng = np.random.default_rng(4)
    n = BATCH * 4 - 9
    users, items = rng.integers(0, NUM_USERS, n), rng.integers(0, NUM_ITEMS, n)
    log_q = torch.tensor(np.log(rng.dirichlet(np.ones(NUM_ITEMS + 1)) + 1e-9), dtype=torch.float32)
    perm = rng.permutation(BATCH * 4)

    state = bridge.state_from_numpy(start, device="cpu")
    ds = DeviceDataset(users, items, BATCH, device="cpu")
    prog = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, num_items=NUM_ITEMS,
                         device="cpu")
    state, epoch_m = prog(state, ds.columns, 0, log_q, perm=perm)
    loop_end = bridge.state_to_numpy(state)

    state = bridge.state_from_numpy(start, device="cpu")
    step = sparse.make_sparse_step_fn(cfg, make_optimizer(cfg.training), num_items=NUM_ITEMS)
    gen = torch.Generator().manual_seed(cfg.training.seed + 1)
    sel = torch.from_numpy(perm).view(ds.num_steps, BATCH)
    sums = {}
    for i in range(ds.num_steps):
        batch = {k: v[sel[i]] for k, v in ds.columns.items()}
        state, m = step(state, batch, gen, log_q)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    one_by_one = bridge.state_to_numpy(state)

    for k, v in sums.items():
        np.testing.assert_allclose(float(epoch_m[k]), v / ds.num_steps, rtol=1e-5, err_msg=k)
    for part in ("params", "table_state", "opt_state"):
        la, _ = jax.tree_util.tree_flatten(loop_end[part])
        lb, _ = jax.tree_util.tree_flatten(one_by_one[part])
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5, atol=1e-7,
                                       err_msg=part)

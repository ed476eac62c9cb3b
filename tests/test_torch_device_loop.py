"""The port's device loop (``training/device_loop.py``) against the JAX
package's, on the CPU, where the port's epoch runs its step eagerly.

Setting (``tests/test_device_loop.py``'s): about 300 users x 120 items,
embedding 16, towers [32,16], batch 128, float32 compute, dropout 0, log q.
Both sides start from the JAX initial state (through the bridge) and walk
the same rows: the port is handed JAX's own permutation,
``jax.random.permutation(fold_in(PRNGKey(seed + 1), epoch), n)``.

Tolerances: the epoch-mean loss rtol 1e-4; tables, packed moments and tower
params rtol 1e-4 / atol 1e-5 (``test_torch_trainer.py``'s ``STATE_TOL``).
"""

import functools

import jax
import numpy as np
import pytest

from test_torch_bridge import jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.training.device_loop import DeviceDataset as JaxDeviceDataset
from twotower_tpu.training.device_loop import DeviceTrainer as JaxDeviceTrainer
from twotower_tpu.training.device_loop import make_epoch_fn as jax_make_epoch_fn
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import Preprocessor, generate_interactions
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.training import make_optimizer
from twotower_tpu_torch.training.device_loop import (
    DeviceDataset,
    DeviceTrainer,
    epoch_seed,
    make_epoch_fn,
)

OVERRIDES = {
    "model.embedding_dim": 16,
    "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "training.batch_size": 128,
    "training.epochs": 6,
    "preprocessing.min_interactions_per_user": 2,
    "preprocessing.min_interactions_per_item": 2,
}
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
SCHEDULE = {"training.warmup_steps": 10, "training.decay_steps": 50}


@functools.cache
def _data():
    cfg = Config().with_overrides(OVERRIDES)
    pp = Preprocessor(cfg.preprocessing)
    data = pp.process(generate_interactions(
        num_users=300, num_items=120, num_interactions=8000, noise=0.2, affinity_scale=3.0))
    return pp, pp.split_data(data)


def _log_q(pp):
    return np.log(pp.vocab.items.frequencies + 1e-12).astype(np.float32)


class TestDeviceDataset:
    def test_padding_and_steps(self):
        ds = DeviceDataset(np.arange(10), np.arange(10), batch_size=4, device="cpu")
        assert ds.num_steps == 3 and ds.num_examples == 10
        assert ds.columns["user_idx"].shape == (12,)
        assert float(ds.columns["weight"][-1]) == 0.0  # padded row
        assert float(ds.columns["weight"][9]) == 1.0
        assert int(ds.columns["item_idx"][-1]) == 0

    def test_exact_multiple_is_not_padded(self):
        ds = DeviceDataset(np.arange(8), np.arange(8), batch_size=4, device="cpu")
        assert ds.num_steps == 2 and ds.columns["weight"].sum() == 8

    def test_matches_jax_columns(self):
        _, splits = _data()
        ours = DeviceDataset.from_interactions(splits.train, 128, device="cpu")
        ref = JaxDeviceDataset.from_interactions(splits.train, 128)
        assert ours.num_steps == ref.num_steps
        for k, v in ref.columns.items():
            np.testing.assert_array_equal(ours.columns[k].numpy(), np.asarray(v), err_msg=k)

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            DeviceDataset(np.array([]), np.array([]), batch_size=4, device="cpu")


def _two_epochs(extra):
    """Two epochs of JAX's ``make_epoch_fn`` and of the port's (JAX's
    permutations handed over) from the JAX initial state."""
    over = {**OVERRIDES, **extra}
    cfg, jcfg = Config().with_overrides(over), JaxConfig().with_overrides(over)
    pp, splits = _data()
    nu, ni = len(pp.vocab.users), len(pp.vocab.items)
    log_q = _log_q(pp)
    jds = JaxDeviceDataset.from_interactions(splits.train, 128)
    jstate = JaxDeviceTrainer(jcfg).init_state(nu, ni)
    start = jax_state_to_numpy(jstate)
    jfn = jax_make_epoch_fn(jcfg, jax_make_optimizer(jcfg.training), jds.num_steps,
                            donate=False)
    ds = DeviceDataset.from_interactions(splits.train, 128, device="cpu")
    fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, num_items=ni,
                       device="cpu")
    state = bridge.state_from_numpy(start, device="cpu")
    lq = bridge.params_from_numpy(log_q)
    n = ds.num_steps * 128
    base = jax.random.PRNGKey(jcfg.training.seed + 1)
    losses = []
    for epoch in range(2):
        rng = jax.random.fold_in(base, epoch)
        jstate, jm = jfn(jstate, jds.columns, rng, jax.numpy.asarray(log_q), None)
        perm = np.asarray(jax.random.permutation(rng, n))
        state, m = fn(state, ds.columns, epoch, lq, perm=perm)
        losses.append((float(m["loss"]), float(jm["loss"])))
    return state, jstate, losses


@pytest.mark.parametrize("schedule", [False, True], ids=["constant_lr", "warmup_cosine"])
def test_two_epochs_match_jax(schedule):
    state, jstate, losses = _two_epochs(SCHEDULE if schedule else {})
    for ours, ref in losses:
        np.testing.assert_allclose(ours, ref, rtol=1e-4)
    ours, ref = bridge.state_to_numpy(state), jax_state_to_numpy(jstate)
    assert ours["step"] == ref["step"] == ours["opt_state"]["count"] > 0
    for part in ("params", "table_state", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(ours[part])
        lb, tb = jax.tree_util.tree_flatten(ref[part])
        assert ta == tb, part
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **STATE_TOL, err_msg=part)


def test_epoch_draws_its_own_permutation_from_the_seed():
    """Without ``perm`` the epoch's order comes from ``epoch_seed``: the
    same seed and epoch give the same state, another epoch another one."""
    cfg = Config().with_overrides(OVERRIDES)
    pp, splits = _data()
    nu, ni = len(pp.vocab.users), len(pp.vocab.items)
    ds = DeviceDataset.from_interactions(splits.train, 128, device="cpu")
    trainer = DeviceTrainer(cfg, device="cpu")
    start = bridge.state_to_numpy(trainer.init_state(nu, ni))
    tables = []
    for epoch in (0, 0, 1):
        fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, device="cpu")
        state, _ = fn(bridge.state_from_numpy(start), ds.columns, epoch)
        tables.append(state.params["item_embedding"].numpy())
    np.testing.assert_array_equal(tables[0], tables[1])
    assert not np.array_equal(tables[0], tables[2])
    assert epoch_seed(41, 0) != epoch_seed(41, 1) != epoch_seed(42, 0)


def _fit(cfg, pp, splits):
    ni = len(pp.vocab.items)
    ev = Evaluator(cfg, ni, batch_size=256, device="cpu")
    trainer = DeviceTrainer(
        cfg, log_q=_log_q(pp), num_items=ni, device="cpu",
        evaluate_fn=ev.make_evaluate_fn(splits.val.user_idx, splits.val.item_idx),
    )
    state = trainer.init_state(len(pp.vocab.users), ni)
    ds = DeviceDataset.from_interactions(splits.train, cfg.training.batch_size, device="cpu")
    return trainer.fit(state, ds), ni


def test_device_trainer_learns_and_is_deterministic():
    cfg = Config().with_overrides({**OVERRIDES, "model.dropout_rate": 0.1})
    pp, splits = _data()
    res, ni = _fit(cfg, pp, splits)
    again, _ = _fit(cfg, pp, splits)
    assert len(res.history) == cfg.training.epochs
    assert res.history[-1]["loss"] < res.history[0]["loss"]
    assert res.best_metric > 2 * 10 / ni
    assert res.state.step == res.state.opt_state.count >= res.best_step > 0
    for name in ("user_embedding", "item_embedding"):
        np.testing.assert_array_equal(res.state.params[name].numpy(),
                                      again.state.params[name].numpy())
    assert res.train_examples_per_sec > 0 and res.steady_examples_per_sec > 0


def test_unported_options_raise():
    cfg = Config().with_overrides(OVERRIDES)
    # The mesh path, once unported, builds now (test_torch_mesh_eval.py runs
    # its epoch against JAX's): the trainer takes the mesh's device, a CPU
    # mesh refuses a CUDA graph, and so does a gloo mesh over CUDA tensors
    # (its collectives wait on the host), naming the backend before it
    # touches the card.
    from types import SimpleNamespace

    import torch

    mesh = SimpleNamespace(device=torch.device("cpu"), backend="gloo")
    assert DeviceTrainer(cfg, mesh=mesh).device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        make_epoch_fn(cfg, make_optimizer(cfg.training), 3, mesh=mesh, capture=True)
    gloo_on_card = SimpleNamespace(device=torch.device("cuda", 0), backend="gloo")
    with pytest.raises(ValueError, match="gloo mesh.*nccl"):
        make_epoch_fn(cfg, make_optimizer(cfg.training), 3, mesh=gloo_on_card, capture=True)
    # The text tower is ported: the tokens go to the device with the trainer.
    text = cfg.with_overrides({"model.text_buckets": 64, "model.text_tokens": 2})
    trainer = DeviceTrainer(text, item_tokens=np.zeros((3, 2), np.int32), device="cpu")
    assert trainer.item_tokens.device.type == "cpu" and trainer.item_tokens.shape == (3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        make_epoch_fn(cfg, make_optimizer(cfg.training), 3, device="cpu", capture=True)
    fn = make_epoch_fn(cfg, make_optimizer(cfg.training), 3, device="cpu")
    ds = DeviceDataset(np.arange(10), np.arange(10), batch_size=128, device="cpu")
    state = DeviceTrainer(cfg, device="cpu").init_state(20, 20)
    with pytest.raises(ValueError, match="rows"):
        fn(state, ds.columns, 0)

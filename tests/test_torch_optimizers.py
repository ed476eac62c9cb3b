"""The port's optimizers against optax (the JAX package's ``make_optimizer``
chains): adam, adamw, adagrad and sgd, each with and without weight decay
and a warmup + cosine schedule, over 5 in-place updates, eager and with the
count and learning rate as device tensors (the CUDA-graph path); every
state crosses the bridge both ways and survives a checkpoint; an adam
checkpoint in the layout written before the other optimizers existed
still restores.

optax and the port both compute in float32, in the same order of
operations and without fused multiply-adds, so 5 updates agree to rtol
1e-5 / atol 1e-7.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_bridge import (
    assert_trees_equal,
    jax_opt_to_numpy,
    jax_state_to_numpy,
    numpy_to_jax_state,
)
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.training.state import TrainState as JaxTrainState
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step
from twotower_tpu_torch.training.state import (
    Adagrad,
    Adam,
    AdamState,
    RssState,
    Sgd,
    SgdState,
    TrainState,
    lr_at,
    opt_state_to_tree,
    tree_map,
)
from twotower_tpu_torch.utils.checkpoint import CheckpointManager

OPTIMIZERS = ["adam", "adamw", "adagrad", "sgd"]
SCHEDULE = {"training.warmup_steps": 2, "training.decay_steps": 5}
TOL = dict(rtol=1e-5, atol=1e-7)
SMALL = {
    "model.embedding_dim": 8,
    "model.user_tower_dims": [16, 8],
    "model.item_tower_dims": [16, 8],
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "training.batch_size": 16,
}
ADAM_V1 = Path(__file__).parent / "fixtures" / "adam_v1_checkpoint"


def _overrides(name, wd, schedule):
    over = {"training.optimizer": name, "training.weight_decay": wd,
            "training.learning_rate": 0.05}
    return {**over, **(SCHEDULE if schedule else {})}


def _params(rng):
    return {
        "user_embedding": rng.normal(size=(16, 4)).astype(np.float32),
        "user_tower": [{"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                        "bias": rng.normal(size=(3,)).astype(np.float32)}],
    }


@pytest.mark.parametrize("clock", [False, True], ids=["eager", "device_clock"])
@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "schedule"])
@pytest.mark.parametrize("wd", [0.0, 0.01], ids=["no_decay", "decay"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_matches_optax(name, wd, schedule, clock):
    over = _overrides(name, wd, schedule)
    jtx = jax_make_optimizer(JaxConfig().with_overrides(over).training)
    cfg = Config().with_overrides(over).training
    opt = make_optimizer(cfg)
    rng = np.random.default_rng(0)
    start = _params(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, start)
    jstate = jtx.init(jparams)
    params = bridge.params_from_numpy(start)
    state = opt.init(params)
    count = torch.zeros((), dtype=torch.float32)
    for _ in range(5):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(size=np.shape(a)).astype(np.float32), start)
        updates, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = bridge.params_from_numpy(grads)
        if clock:
            state = opt.update_(params, tgrads, state, clock=count, lr=lr_at(cfg, count))
            count += 1.0
        else:
            state = opt.update_(params, tgrads, state)
    assert state.count == 5
    assert_trees_equal(bridge.params_to_numpy(params), jax.device_get(jparams), **TOL)
    want = jax_opt_to_numpy(jstate, 5)
    got = opt_state_to_tree(state)
    assert sorted(got) == sorted(want)
    for key in got:
        if key != "count":
            assert_trees_equal(bridge.params_to_numpy(got[key]), want[key], **TOL)


@pytest.mark.parametrize(
    "name,wd,cls,state_cls,decoupled",
    [("adam", 0.0, Adam, AdamState, False), ("adam", 0.01, Adam, AdamState, False),
     ("adamw", 0.01, Adam, AdamState, True), ("adagrad", 0.0, Adagrad, RssState, False),
     ("sgd", 0.01, Sgd, SgdState, False)],
)
def test_make_optimizer_builds_the_jax_chain(name, wd, cls, state_cls, decoupled):
    opt = make_optimizer(Config().with_overrides(_overrides(name, wd, False)).training)
    assert type(opt) is cls and opt.weight_decay == wd and opt.decoupled == decoupled
    assert isinstance(opt.init({"w": torch.zeros(2)}), state_cls)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(Config().with_overrides({"training.optimizer": "lamb"}).training)


def _jax_dense_state(over, steps=2):
    """A dense JAX state after ``steps`` optimizer updates with random
    gradients, so every slot holds non-trivial values."""
    jcfg = JaxConfig().with_overrides({**SMALL, **over})
    tx = jax_make_optimizer(jcfg.training)
    params = jtt.init_params(jax.random.PRNGKey(0), jcfg.model, 20, 10)
    state = JaxTrainState.create(params, tx)
    rng = np.random.default_rng(1)
    for _ in range(steps):
        grads = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32), state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        state = JaxTrainState(step=state.step + 1,
                              params=optax.apply_updates(state.params, updates),
                              opt_state=opt_state)
    return state, tx


@pytest.mark.parametrize("schedule", [False, True], ids=["constant", "schedule"])
@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adam", 0.01), ("adamw", 0.01),
                                     ("adagrad", 0.0), ("sgd", 0.0), ("sgd", 0.01)])
def test_state_crosses_the_bridge(name, wd, schedule):
    jstate, tx = _jax_dense_state(_overrides(name, wd, schedule))
    tree = jax_state_to_numpy(jstate)
    assert tree["opt_state"]["count"] == 2 and tree["table_state"] is None
    port = bridge.state_from_numpy(tree)
    assert port.table_state is None and port.opt_state.count == 2
    back = bridge.state_to_numpy(port)
    assert_trees_equal(back, tree)
    # ... and into the JAX layout again: the same optax state, leaf for leaf.
    again = numpy_to_jax_state(back, tx)
    assert (jax.tree_util.tree_structure(again.opt_state)
            == jax.tree_util.tree_structure(jstate.opt_state))
    assert_trees_equal(jax.device_get(again.opt_state), jax.device_get(jstate.opt_state))


@pytest.mark.parametrize("name,wd", [("adam", 0.0), ("adamw", 0.01), ("adagrad", 0.0),
                                     ("sgd", 0.0), ("adam", 0.01)])
def test_state_survives_a_checkpoint(tmp_path, name, wd):
    cfg = Config().with_overrides({**SMALL, **_overrides(name, wd, False),
                                   "training.sparse_table_updates": False})
    opt = make_optimizer(cfg.training)
    state = init_train_state(cfg, opt, 20, 10, device="cpu")
    assert state.table_state is None  # the dense step's layout
    gen = torch.Generator().manual_seed(3)
    state.opt_state = type(state.opt_state)(
        count=4, **{k: tree_map(lambda t: torch.randn(t.shape, generator=gen), v)
                    for k, v in opt_state_to_tree(state.opt_state).items() if k != "count"})
    state.step = 4
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(4, state, metrics={"val/recall@10": 0.5})
    fresh = init_train_state(cfg.with_overrides({"training.seed": 9}), opt, 20, 10,
                             device="cpu")
    restored, meta = mgr.restore(fresh)
    assert meta["step"] == 4 and type(restored.opt_state) is type(state.opt_state)
    assert_trees_equal(bridge.state_to_numpy(restored), bridge.state_to_numpy(state))
    # A checkpoint of another optimizer's layout does not restore.
    other = "sgd" if name != "sgd" else "adam"
    ocfg = cfg.with_overrides({"training.optimizer": other})
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore(init_train_state(ocfg, make_optimizer(ocfg.training), 20, 10, device="cpu"))


def test_adam_v1_checkpoint_still_restores():
    """A checkpoint the port wrote when dense Adam was its only optimizer
    state (``opt_state: {count, mu, nu}``, sparse tables: 10 users, 6 items,
    embedding 4, two steps): it restores into today's sparse adam state
    and trains on."""
    cfg = Config().with_overrides({
        "model.embedding_dim": 4, "model.user_tower_dims": [8, 4],
        "model.item_tower_dims": [8, 4], "model.compute_dtype": "float32",
        "model.dropout_rate": 0.0, "training.batch_size": 8})
    opt = make_optimizer(cfg.training)
    mgr = CheckpointManager(ADAM_V1)
    meta = json.loads((ADAM_V1 / "step_0000000002" / "meta.json").read_text())
    assert meta["format"] == "twotower_tpu_torch.checkpoint.v1"
    raw = torch.load(ADAM_V1 / "step_0000000002" / "state.pt", weights_only=True)
    assert sorted(raw["opt_state"]) == ["count", "mu", "nu"]
    state, meta = mgr.restore(init_train_state(cfg, opt, 10, 6, device="cpu"))
    assert isinstance(state.opt_state, AdamState) and state.step == state.opt_state.count == 2
    assert meta["epoch"] == 1 and mgr.best_step() == 2
    got = bridge.state_to_numpy(state)
    want = bridge.state_to_numpy(TrainState(
        step=raw["step"], params=raw["params"],
        opt_state=AdamState(count=raw["opt_state"]["count"], mu=raw["opt_state"]["mu"],
                            nu=raw["opt_state"]["nu"]),
        table_state=raw["table_state"]))
    assert_trees_equal(got, want)
    assert np.abs(got["opt_state"]["mu"]["user_tower"][0]["kernel"]).max() > 0
    step = make_train_step(cfg, opt, device="cpu")
    rng = np.random.default_rng(0)
    state, m = step(state, {"user_idx": rng.integers(0, 10, 8).astype(np.int32),
                            "item_idx": rng.integers(0, 6, 8).astype(np.int32)}, None)
    assert state.step == 3 and np.isfinite(float(m["loss"]))

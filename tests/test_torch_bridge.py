"""Bridge between the JAX package and the PyTorch port: parameters and the
sparse train state survive a round trip in both directions unchanged.

Also holds what the other port tests share: the JAX-side conversions
(``jax_state_to_numpy`` / ``numpy_to_jax_state``) and the ``one_torch_thread``
fixture."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.training.state import TrainState as JaxTrainState
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import init_train_state, make_optimizer


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch while a port test runs: the suite runs
    in several worker processes at once, and the small port tests gain
    nothing from a thread per core that the other workers' JAX CPU-mesh
    tests need."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = {
    "model.embedding_dim": 32,
    "model.user_tower_dims": [64, 32],
    "model.item_tower_dims": [64, 32],
    "training.batch_size": 256,
}


def jax_opt_to_numpy(opt_state, step: int) -> dict:
    """An optax state of the JAX package's ``make_optimizer`` chains ->
    the bridge's ``{"count": int, <slots>}``: ``mu``/``nu`` from
    ``ScaleByAdamState``, ``sum_of_squares`` from ``ScaleByRssState``; the
    count from the adam or schedule state, else the train step (optax
    keeps none for a constant-lr sgd or adagrad)."""
    out: dict = {}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            out.update(count=int(s.count), mu=jax.device_get(s.mu), nu=jax.device_get(s.nu))
        elif isinstance(s, optax.ScaleByRssState):
            out["sum_of_squares"] = jax.device_get(s.sum_of_squares)
        elif isinstance(s, optax.ScaleByScheduleState):
            out.setdefault("count", int(s.count))
        elif isinstance(s, tuple) and not isinstance(s, optax.EmptyState):
            for x in s:
                walk(x)

    walk(opt_state)
    out.setdefault("count", step)
    return out


def jax_state_to_numpy(state) -> dict:
    """A JAX ``TrainState`` (sparse or dense, any optimizer of
    ``make_optimizer``) -> the bridge's numpy layout."""
    return {
        "step": int(state.step),
        "params": jax.device_get(state.params),
        "opt_state": jax_opt_to_numpy(state.opt_state, int(state.step)),
        "table_state": (None if state.table_state is None
                        else jax.device_get(state.table_state)),
    }


def numpy_to_jax_state(tree: dict, optimizer=None):
    """The bridge's numpy layout -> a JAX ``TrainState`` whose ``opt_state``
    has the layout of ``optimizer`` (a JAX ``make_optimizer`` chain;
    default the sparse path's constant-lr ``optax.adam``)."""
    put = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    opt = tree["opt_state"]
    count = jnp.asarray(opt["count"], jnp.int32)
    params = put(tree["params"])
    sparse = tree["table_state"] is not None
    covered = ({k: v for k, v in params.items() if not k.endswith("_embedding")} if sparse
               else params)
    template = (optax.adam(1e-3) if optimizer is None else optimizer).init(covered)

    def fill(s):
        if isinstance(s, optax.ScaleByAdamState):
            return optax.ScaleByAdamState(count=count, mu=put(opt["mu"]), nu=put(opt["nu"]))
        if isinstance(s, optax.ScaleByRssState):
            return optax.ScaleByRssState(sum_of_squares=put(opt["sum_of_squares"]))
        if isinstance(s, optax.ScaleByScheduleState):
            return optax.ScaleByScheduleState(count=count)
        if isinstance(s, tuple) and not isinstance(s, optax.EmptyState):
            return tuple(fill(x) for x in s)
        return s

    return JaxTrainState(
        step=jnp.asarray(tree["step"], jnp.int32),
        params=params,
        opt_state=fill(template),
        table_state=put(tree["table_state"]) if sparse else None,
    )


def jax_sparse_state(cfg, num_users: int, num_items: int, seed: int = 0):
    params = jtt.init_params(jax.random.PRNGKey(seed), cfg.model, num_users, num_items)
    return JaxTrainState.for_config(params, jax_make_optimizer(cfg.training), cfg)


def assert_trees_equal(a, b, **tol):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        if tol:
            np.testing.assert_allclose(x, y, **tol)
        else:
            np.testing.assert_array_equal(x, y)


def _advanced(tree: dict, rng: np.random.Generator) -> dict:
    """A state with non-zero moments and count, so the round trip carries
    every field (a fresh state's zeros would hide a dropped one)."""
    noisy = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(size=np.shape(a))).astype(np.float32), tree
    )
    noisy["step"] = 7
    noisy["opt_state"]["count"] = 7
    return noisy


def test_params_round_trip(rng):
    cfg = JaxConfig().with_overrides(SMALL)
    params = jax.device_get(
        jtt.init_params(jax.random.PRNGKey(3), cfg.model, 100, 50)
    )
    port = bridge.params_from_numpy(params)
    assert port["user_tower"][0]["kernel"].shape == (32, 64)  # JAX [in, out]
    assert port["item_embedding"].dtype == torch.float32
    assert_trees_equal(bridge.params_to_numpy(port), params)


def test_state_round_trip_from_jax(rng):
    cfg = JaxConfig().with_overrides(SMALL)
    tree = _advanced(jax_state_to_numpy(jax_sparse_state(cfg, 100, 50)), rng)
    back = bridge.state_to_numpy(bridge.state_from_numpy(tree))
    assert back["step"] == 7 and back["opt_state"]["count"] == 7
    assert_trees_equal(back, tree)


def test_state_round_trip_from_port(rng):
    cfg = Config().with_overrides(SMALL)
    state = init_train_state(cfg, make_optimizer(cfg.training), 100, 50, device="cpu")
    tree = _advanced(bridge.state_to_numpy(state), rng)
    jstate = numpy_to_jax_state(tree)
    assert_trees_equal(jax_state_to_numpy(jstate), tree)
    # The port's state has exactly the JAX state's structure and shapes.
    jax_tree = jax_state_to_numpy(jax_sparse_state(JaxConfig().with_overrides(SMALL), 100, 50))
    assert jax.tree_util.tree_structure(jax_tree) == jax.tree_util.tree_structure(tree)
    for x, y in zip(jax.tree_util.tree_leaves(jax_tree), jax.tree_util.tree_leaves(tree)):
        assert np.shape(x) == np.shape(y)


def test_state_from_numpy_layout():
    cfg = JaxConfig().with_overrides(SMALL)
    state = bridge.state_from_numpy(
        jax_state_to_numpy(jax_sparse_state(cfg, 100, 50)), device="cpu"
    )
    assert state.params["user_embedding"].device.type == "cpu"
    # 50 items pad to one 128-row lane multiple; moments pack [mu | nu].
    assert state.table_state["item_embedding"]["moments"].shape == (128, 64)
    assert state.opt_state.mu["user_tower"][1]["kernel"].shape == (64, 32)

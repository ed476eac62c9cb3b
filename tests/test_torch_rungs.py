"""The port's execution-rung choice (``training/rungs.py``) against the JAX
package's: the same decision, reason and shuffle window on a grid of
budgets (device-fit, host-fit, stream, unknown budgets, multi-process), and
the same ``train_state_bytes`` / ``eval_corpus_bytes``; the port's state
estimate against its own ``TrainState``; ``device_free_bytes`` on the CPU."""

import itertools

import pytest

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.training import rungs as jax_rungs
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import init_train_state, make_optimizer, rungs
from twotower_tpu_torch.training.state import tree_leaves

GB = 1 << 30
# (n_train, num_users, num_items): the 50M lifecycle, a 400M-row log with
# 40M users, the 571M corpus, giant tables over few rows, a small run.
SIZES = [
    (50_000_000, 2_500_000, 1_200_000),
    (400_000_000, 40_000_000, 8_000_000),
    (571_000_000, 50_000_000, 30_000_000),
    (2_000_000, 100_000_000, 60_000_000),
    (1_000_000, 100_000, 50_000),
]
DEVICE = [None, 16 * GB, 79 * GB]
HOST = [None, 32 * GB, 256 * GB]
CONFIGS = [{}, {"retrieval.eval_exact": False, "retrieval.eval_corpus_dtype": "bfloat16"},
           {"model.embedding_dim": 64}]


@pytest.mark.parametrize("over", CONFIGS, ids=["default", "bf16_corpus", "emb64"])
def test_decision_grid_matches_jax(over):
    cfg, jcfg = Config().with_overrides(over), JaxConfig().with_overrides(over)
    seen = set()
    for (n, nu, ni), dev, host, multi, has_eval in itertools.product(
        SIZES, DEVICE, HOST, (False, True), (True, False)
    ):
        kw = dict(n_train=n, num_users=nu, num_items=ni, device_free_bytes=dev,
                  host_available_bytes=host, multi_process=multi, has_eval=has_eval)
        ours = rungs.choose_execution_rung(config=cfg, **kw)
        ref = jax_rungs.choose_execution_rung(config=jcfg, **kw)
        assert (ours.rung, ours.shuffle_buffer, ours.reason) == (
            ref.rung, ref.shuffle_buffer, ref.reason), kw
        seen.add(ours.rung)
    assert seen == {"device_loop", "host", "stream"}


@pytest.mark.parametrize("over", CONFIGS, ids=["default", "bf16_corpus", "emb64"])
def test_byte_estimates_match_jax(over):
    cfg, jcfg = Config().with_overrides(over), JaxConfig().with_overrides(over)
    for _, nu, ni in SIZES:
        assert rungs.train_state_bytes(cfg, nu, ni) == jax_rungs.train_state_bytes(jcfg, nu, ni)
        assert rungs.eval_corpus_bytes(cfg, ni) == jax_rungs.eval_corpus_bytes(jcfg, ni)


def test_state_bytes_track_the_ports_state():
    """Within the padding slop (dead rows, 128-row table padding)."""
    cfg = Config()
    state = init_train_state(cfg, make_optimizer(cfg.training), 1000, 700, device="cpu")
    leaves = [state.params, state.opt_state.mu, state.opt_state.nu, state.table_state]
    real = sum(t.numel() * t.element_size() for t in tree_leaves(leaves))
    assert rungs.train_state_bytes(cfg, 1000, 700) == pytest.approx(real, rel=0.2)


def test_unknown_device_budget_assumes_16_gb():
    cfg = Config()
    kw = dict(n_train=1_000_000, num_users=100_000, num_items=50_000, config=cfg,
              host_available_bytes=None)
    unknown = rungs.choose_execution_rung(device_free_bytes=None, **kw)
    assert unknown.rung == "device_loop" and "of 16384 MiB" in unknown.reason


def test_budgets_on_this_host():
    assert rungs.device_free_bytes("cpu") is None
    host = rungs.host_available_bytes()
    assert host is None or host > 0

"""The port's ``CheckpointManager`` (torch-native format): the cases of the
JAX package's ``tests/test_serving_checkpoint.py::TestCheckpoint`` — round
trip, pruning, async flush and busy skip, the accept interval, worker
failures, flush timeouts, the starvation backstop, preemption saves and
``best_step`` with the backstop's proxy — plus the format's own rules
(``weights_only`` load, ``meta.json`` last, shape checks)."""

import json
import logging
import shutil
import time

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_data import small_dataset
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import BatchPipeline
from twotower_tpu_torch.evaluation.evaluate import restore_params
from twotower_tpu_torch.training import init_train_state, make_optimizer
from twotower_tpu_torch.training.loop import EarlyStopping, Trainer, ensure_final_persisted
from twotower_tpu_torch.utils.checkpoint import FORMAT, CheckpointManager

TINY = {
    "model.embedding_dim": 16,
    "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
    "training.batch_size": 32,
    "preprocessing.min_interactions_per_user": 2,
    "preprocessing.min_interactions_per_item": 2,
}


def _cfg(extra=None):
    return Config().with_overrides({**TINY, **(extra or {})})


def _state(seed, users=30, items=20):
    cfg = _cfg({"training.seed": seed})
    return init_train_state(cfg, make_optimizer(cfg.training), users, items, device="cpu")


def _user_table(state):
    return state.params["user_embedding"].numpy().copy()


def test_save_restore_roundtrip(tmp_path):
    state = _state(1, 50, 30)
    state.step = 10
    state.table_state["item_embedding"]["moments"].normal_()
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    mgr.save(10, state, metrics={"recall@10": 0.5}, extra={"epoch": 3})
    restored, meta = mgr.restore(_state(2, 50, 30))
    want, got = bridge.state_to_numpy(state), bridge.state_to_numpy(restored)
    assert got["step"] == 10
    for part in ("params", "opt_state", "table_state"):
        np.testing.assert_equal(got[part], want[part])
    assert meta["metrics"]["recall@10"] == 0.5
    assert meta["epoch"] == 3 and meta["format"] == FORMAT
    # The state file is tensors and plain containers only.
    torch.load(tmp_path / "ckpt" / "step_0000000010" / "state.pt", weights_only=True)


def test_restore_checks_the_template(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, _state(0, 50, 30))
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(_state(0, 500, 30))


def test_prune_keeps_latest(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_incomplete_save_is_not_a_step(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(1, _state(0))
    (tmp_path / "ckpt" / "step_0000000002").mkdir()  # crashed before meta.json
    assert mgr.all_steps() == [1]
    mgr.save(2, _state(0))  # clears the leftover and writes
    assert mgr.all_steps() == [1, 2]


def test_restore_empty_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "none")
    with pytest.raises(FileNotFoundError):
        mgr.restore(None)


def test_async_save_flush_and_busy_skip(tmp_path):
    """Saves return right after a device snapshot and a worker writes them;
    a request while a save is in flight is skipped; a later request with
    the worker idle is accepted; flush() drains to disk."""
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10, async_save=True)
    slow_orig = mgr._save_now

    def slow_save(step, state, **kw):
        time.sleep(0.3)  # hold the worker so later requests hit busy-skip
        return slow_orig(step, state, **kw)

    mgr._save_now = slow_save
    state1 = _state(1)
    expect1 = _user_table(state1)
    mgr.save(1, state1, metrics={"recall@10": 0.1})
    state1.params["user_embedding"].add_(1.0)  # the snapshot is independent
    time.sleep(0.05)  # let the worker take the request
    mgr.save(2, _state(2))  # in flight -> skipped, no snapshot
    mgr.flush()
    assert mgr.all_steps() == [1]
    state3 = _state(3)
    expect3 = _user_table(state3)
    mgr.save(3, state3, metrics={"recall@10": 0.3})
    mgr.flush()
    assert mgr.all_steps() == [1, 3]
    restored, meta = mgr.restore(_state(9), step=3)
    np.testing.assert_array_equal(_user_table(restored), expect3)
    assert meta["metrics"]["recall@10"] == pytest.approx(0.3)
    restored1, _ = mgr.restore(_state(9), step=1)
    np.testing.assert_array_equal(_user_table(restored1), expect1)


def test_async_save_accept_interval(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10, async_save=True, min_interval_s=60)
    state = _state(0)
    mgr.save(1, state)
    mgr.flush()
    mgr.save(2, state)  # inside the 60 s window -> skipped
    mgr.flush()
    assert mgr.all_steps() == [1]


def test_first_save_accepted_on_young_monotonic_clock(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=True, min_interval_s=3600)
    monkeypatch.setattr(time, "monotonic", lambda: 12.0)  # freshly booted host
    mgr.save(1, _state(0))
    mgr.flush()
    assert mgr.all_steps() == [1]


def test_async_save_worker_failure_surfaces(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", keep=2, async_save=True)

    def boom(step, s, **kw):
        raise RuntimeError("disk on fire")

    mgr._save_now = boom
    mgr.save(1, _state(0))
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.flush()


def test_flush_timeout_raises(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", async_save=True)
    slow_orig = mgr._save_now

    def slow_save(step, s, **kw):
        time.sleep(0.5)
        return slow_orig(step, s, **kw)

    mgr._save_now = slow_save
    mgr.save(1, _state(0))
    with pytest.raises(TimeoutError):
        mgr.flush(timeout=0.05)
    mgr.flush()  # an untimed flush drains normally
    assert mgr.all_steps() == [1]


def test_starvation_backstop_persists_final_state(tmp_path):
    """When every improving save after the first is skipped, the end-of-fit
    backstop persists the FINAL state, so the newest durable checkpoint
    never predates the best validation."""
    state = _state(0)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=3, async_save=True, min_interval_s=3600)
    mgr.save(10, state)  # epoch-0 save accepted
    mgr.flush()
    mgr.save(50, state)  # later improving epochs: skipped (interval)
    mgr.flush()
    assert mgr.all_steps() == [10]
    stopper = EarlyStopping(patience=5)
    stopper.best, stopper.best_step = 0.5, 50
    state.step = 60
    ensure_final_persisted(mgr, state, stopper, epoch=7)
    assert mgr.latest_step() == 60  # force= bypassed the interval
    _, meta = mgr.restore(state, step=60)
    assert meta.get("post_starvation_final") is True
    assert meta["metrics"] == {"best_val_at_stop": 0.5} and meta["epoch"] == 7


def test_preemption_save_inside_skip_window_is_durable(tmp_path):
    """A preemption inside the accept window after an improving epoch still
    persists the preemption-time state: the shutdown branch flushes, then
    force-saves with the resume metadata."""
    cfg = _cfg({"training.epochs": 4, "training.batch_size": 64})
    pp, splits = small_dataset()

    class StopAfterEpoch1:
        calls = 0

        @property
        def should_stop(self):
            StopAfterEpoch1.calls += 1
            return StopAfterEpoch1.calls >= 2  # epoch 0 runs, epoch 1 preempts

    mgr = CheckpointManager(tmp_path / "ckpt", async_save=True, min_interval_s=3600)
    calls = {"n": 0}

    def fake_eval(params):
        calls["n"] += 1
        return {"recall@10": 0.1 * calls["n"]}  # improves every epoch

    trainer = Trainer(cfg, evaluate_fn=fake_eval, checkpoint_manager=mgr,
                      shutdown=StopAfterEpoch1(), device="cpu")
    state = trainer.init_state(len(pp.vocab.users), len(pp.vocab.items))
    res = trainer.fit(state, BatchPipeline(splits.train, cfg.training.batch_size))
    final_step = int(res.state.step)
    assert final_step in mgr.all_steps()
    meta = json.loads((tmp_path / "ckpt" / f"step_{final_step:010d}" / "meta.json").read_text())
    assert meta.get("preempted") is True
    assert meta.get("epoch") == 2


def test_best_step_prefers_highest_metric(tmp_path):
    state = _state(0)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    mgr.save(10, state, metrics={"recall@10": 0.3})
    mgr.save(20, state, metrics={"recall@10": 0.5})
    mgr.save(30, state, metrics={"recall@10": 0.4})
    mgr.save(40, state, extra={"preempted": True})  # no metric
    assert mgr.best_step() == 20
    assert mgr.best_step("recall@10") == 20
    assert mgr.best_step("ndcg@10") is None
    # a backstop whose proxy is BELOW the genuine best: the genuine wins
    mgr.save(45, state, metrics={"best_val_at_stop": 0.45},
             extra={"post_starvation_final": True})
    assert mgr.best_step() == 20
    # a proxy ABOVE every genuine metric: the backstop is the expected best
    shutil.rmtree(tmp_path / "ckpt" / "step_0000000045")
    mgr.save(50, state, metrics={"best_val_at_stop": 0.9},
             extra={"post_starvation_final": True})
    assert mgr.latest_step() == 50
    assert mgr.best_step() == 50
    # a genuine metric EQUAL to the proxy wins the tie
    mgr.save(60, state, metrics={"recall@10": 0.9})
    assert mgr.best_step() == 60


def test_restore_params_prefers_best_metric_step(tmp_path, caplog):
    cfg = _cfg()
    best = _state(1, 20, 20)
    mgr = CheckpointManager(tmp_path / "ckpt", keep=10)
    mgr.save(10, best, metrics={"recall@10": 0.5})
    mgr.save(25, _state(2, 20, 20), metrics={"best_val_at_stop": 0.5},
             extra={"post_starvation_final": True})
    with caplog.at_level(logging.WARNING, logger="twotower_tpu_torch"):
        params, meta = restore_params(cfg, tmp_path / "ckpt", 20, 20, device="cpu")
    assert meta["step"] == 10  # best, not latest (25)
    np.testing.assert_array_equal(params["user_embedding"].numpy(), _user_table(best))
    assert any("best-metric checkpoint" in r.message for r in caplog.records)
    with caplog.at_level(logging.WARNING, logger="twotower_tpu_torch"):
        _, meta25 = restore_params(cfg, tmp_path / "ckpt", 20, 20, step=25, device="cpu")
    assert meta25.get("post_starvation_final") is True
    assert any("POST-STARVATION FINAL" in r.message for r in caplog.records)

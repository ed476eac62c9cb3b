"""The port's ``Trainer.fit`` and exact ``Evaluator`` against the JAX
package's, from one initial state (the JAX state through the bridge).

Setting: the shared small dataset (``test_torch_data.small_dataset``),
embedding 16, towers [32,16], float32 compute, dropout 0, host dedup on,
batch 64, two epochs with validation every epoch.

Tolerances: per-epoch loss rtol 1e-4; final tables, moments and tower
params rtol 1e-4 / atol 1e-5 (the tolerance of test_torch_sparse_step.py,
over ~70 steps here); the validation metrics, and the Evaluator's, within
one rank flip, 1/(rows) absolute."""

import jax
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_data import PREPROCESS, small_dataset
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.data import BatchPipeline as JaxBatchPipeline
from twotower_tpu.evaluation import Evaluator as JaxEvaluator
from twotower_tpu.training.loop import Trainer as JaxTrainer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import BatchPipeline
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.training import Trainer
from twotower_tpu_torch.training.loop import EarlyStopping, TrainResult

OVERRIDES = {
    **PREPROCESS,
    "model.embedding_dim": 16,
    "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
    "model.compute_dtype": "float32",
    "model.dropout_rate": 0.0,
    "training.batch_size": 64,
    "training.epochs": 2,
    "training.log_every_steps": 5,
}
STATE_TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(extra=None):
    over = {**OVERRIDES, **(extra or {})}
    pp, splits = small_dataset()
    return Config().with_overrides(over), JaxConfig().with_overrides(over), pp, splits


def _jax_fit(jcfg, pp, splits):
    """JAX fit from its own initial state; returns (result, start state)."""
    nu, ni = len(pp.vocab.users), len(pp.vocab.items)
    ev = JaxEvaluator(jcfg, ni, batch_size=256)
    trainer = JaxTrainer(
        jcfg, log_q=np.log(pp.vocab.items.frequencies + 1e-12),
        evaluate_fn=ev.make_evaluate_fn(splits.val.user_idx, splits.val.item_idx),
        num_items=ni,
    )
    state = trainer.init_state(nu, ni)
    start = jax_state_to_numpy(state)
    result = trainer.fit(state, JaxBatchPipeline(splits.train, jcfg.training.batch_size))
    return result, start


def _port_fit(cfg, pp, splits, start):
    ni = len(pp.vocab.items)
    ev = Evaluator(cfg, ni, batch_size=256, device="cpu")
    trainer = Trainer(
        cfg, log_q=np.log(pp.vocab.items.frequencies + 1e-12),
        evaluate_fn=ev.make_evaluate_fn(splits.val.user_idx, splits.val.item_idx),
        num_items=ni, device="cpu",
    )
    state = bridge.state_from_numpy(start, device="cpu")
    return trainer.fit(state, BatchPipeline(splits.train, cfg.training.batch_size))


@pytest.fixture(scope="module")
def both_fits():
    cfg, jcfg, pp, splits = _setup()
    jres, start = _jax_fit(jcfg, pp, splits)
    return jres, _port_fit(cfg, pp, splits, start), start, splits


def test_fit_matches_jax_losses_and_validation(both_fits):
    jres, res, _, splits = both_fits
    assert len(res.history) == len(jres.history) == 2
    flip = 1.0 / len(splits.val)
    for ours, ref in zip(res.history, jres.history):
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-4)
        for key in ("val/recall@10", "val/ndcg@10", "val/mrr"):
            assert abs(ours[key] - ref[key]) <= flip, key
    assert res.best_step == jres.best_step
    assert abs(res.best_metric - jres.best_metric) <= flip


def test_fit_matches_jax_final_state(both_fits):
    jres, res, _, _ = both_fits
    ours = bridge.state_to_numpy(res.state)
    ref = jax_state_to_numpy(jres.state)
    assert ours["step"] == ref["step"] > 0
    for part in ("params", "table_state", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(ours[part])
        lb, tb = jax.tree_util.tree_flatten(ref[part])
        assert ta == tb, part
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **STATE_TOL, err_msg=part)


def test_segment_steps_matches_per_step_loop(both_fits):
    """training.segment_steps=6 (a segment size that does NOT divide the
    epoch's batch count) follows the per-step trajectory."""
    _, res, start, splits = both_fits
    cfg, _, pp, _ = _setup({"training.segment_steps": 6})
    assert len(BatchPipeline(splits.train, 64)) % 6 != 0
    seg = _port_fit(cfg, pp, splits, start)
    assert int(seg.state.step) == int(res.state.step)
    a, b = bridge.params_to_numpy(seg.state.params), bridge.params_to_numpy(res.state.params)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x, y, rtol=2e-6, atol=2e-7)
    assert "segment_time_p50_ms" in seg.history[0]


def test_evaluator_matches_jax(both_fits):
    """One set of trained params through both Evaluators (batch 100 over
    the test split: a ragged last batch)."""
    jres, _, _, splits = both_fits
    cfg, jcfg, pp, _ = _setup()
    ni = len(pp.vocab.items)
    params = bridge.params_from_numpy(jax.device_get(jres.state.params))
    ours = Evaluator(cfg, ni, batch_size=100, device="cpu").evaluate(
        params, splits.test.user_idx, splits.test.item_idx)
    ref = JaxEvaluator(jcfg, ni, batch_size=100).evaluate(
        jres.state.params, splits.test.user_idx, splits.test.item_idx)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1.0 / len(splits.test), key


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16"])
def test_approx_evaluator_matches_jax(both_fits, corpus_dtype):
    """Validation mode (``eval_exact=false``): the corpus at
    ``eval_corpus_dtype`` and the serving search, against the JAX
    Evaluator's ``approx_max_k`` (an exact top-k on the CPU); metrics within
    one rank flip."""
    jres, _, _, splits = both_fits
    over = {"retrieval.eval_exact": False, "retrieval.eval_corpus_dtype": corpus_dtype}
    cfg, jcfg, pp, _ = _setup(over)
    ni = len(pp.vocab.items)
    params = bridge.params_from_numpy(jax.device_get(jres.state.params))
    ev = Evaluator(cfg, ni, batch_size=100, device="cpu")
    assert ev._encode_corpus(params).dtype == getattr(torch, corpus_dtype)
    ours = ev.evaluate(params, splits.test.user_idx, splits.test.item_idx)
    ref = JaxEvaluator(jcfg, ni, batch_size=100).evaluate(
        jres.state.params, splits.test.user_idx, splits.test.item_idx)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1.0 / len(splits.test), key


def test_small_corpus_not_padded_to_full_chunk():
    cfg, _, pp, splits = _setup()
    ni = len(pp.vocab.items)
    trainer = Trainer(cfg, device="cpu")
    params = trainer.init_state(len(pp.vocab.users), ni).params
    ev = Evaluator(cfg, ni, batch_size=256, device="cpu")
    assert ev.corpus_chunk_size <= -(-ni // 64) * 64
    assert ev._encode_corpus(params).shape[0] < ni + 64
    m = ev.evaluate(params, splits.val.user_idx, splits.val.item_idx)
    assert 0.0 <= m["recall@10"] <= 1.0


def test_unported_options_raise():
    """The mesh path, once unported, builds now: the Trainer takes the
    mesh's device and builds its step in ``fit`` against the state's layout
    (``test_torch_multiprocess.py`` trains it against JAX's); the text
    tower and the dense step build (``test_torch_text_tower.py`` and
    ``test_torch_dense_step.py`` train them against JAX's)."""
    from types import SimpleNamespace

    cfg, _, _, _ = _setup()
    meshed = Trainer(cfg, mesh=SimpleNamespace(device=torch.device("cpu")))
    assert meshed.device.type == "cpu" and meshed.train_step is None
    text = cfg.with_overrides({"model.text_buckets": 64, "model.text_tokens": 2})
    trainer = Trainer(text, item_tokens=np.zeros((3, 2), np.int32), device="cpu")
    assert "text_embedding" in trainer.init_state(5, 3).params
    dense = Trainer(cfg.with_overrides({"training.sparse_table_updates": False}), device="cpu")
    assert dense.init_state(5, 3).table_state is None


def test_finalize_throughput_and_early_stopping():
    res = TrainResult(state=None)
    res.history = [{"epoch": 0.0, "examples_per_sec": 100.0},
                   {"epoch": 1.0, "examples_per_sec": 400.0}]
    res.finalize_throughput(examples_seen=1000, train_time=4.0, total_time=10.0)
    assert (res.examples_per_sec, res.train_examples_per_sec,
            res.steady_examples_per_sec) == pytest.approx((100.0, 250.0, 400.0))
    empty = TrainResult(state=None)
    empty.finalize_throughput(examples_seen=1000, train_time=4.0, total_time=10.0)
    assert empty.steady_examples_per_sec == pytest.approx(250.0)
    stop = EarlyStopping(patience=2)
    assert [stop.update(v, s) for s, v in enumerate([0.1, 0.2, 0.15, 0.19])] == [
        False, False, False, True]
    assert (stop.best, stop.best_step) == (0.2, 1)

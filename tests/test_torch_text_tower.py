"""The port's hashed text tower against the JAX package's, on the CPU.

- ``features/text_encoder.py``: ``encode``, ``encode_per_item`` (and its
  per-row twin) and ``select_first_item_texts`` bit for bit, falsy
  non-strings included.
- ``models/two_tower.py``: ``pool_rows``/``pool_text``, ``embed_items`` with
  ``text_tokens`` and ``embed_item_table`` with ``item_tokens``, from the
  JAX parameters (a text table included) through the bridge.
- The train steps with ``item_tokens``: the sparse step (in_batch, and
  mixed with JAX's threefry negatives handed in: the negatives' tokens
  too), the dense step, and two device-loop epochs with JAX's permutation,
  each from one bridged state at dropout 0 in float32.
- ``Evaluator`` and ``RetrievalIndex`` with item tokens, and
  ``PreparedDataset.build_item_tokens``.
- The CLI round trip: ``train-model --synthetic-text`` writes
  ``item_tokens.npz``; ``evaluate-model`` reproduces the summary; the exact
  index serves what the evaluation ranks.

Tolerances (``test_torch_sparse_step.py``'s): losses and metrics rtol 1e-5
/ atol 1e-6, the state after three steps rtol 1e-4 / atol 1e-5, towers'
outputs rtol 1e-5 / atol 1e-6, retrieval metrics within one rank flip.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_serving_index import assert_same_results
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.data.prepared import PreparedDataset as JaxPreparedDataset
from twotower_tpu.evaluation import Evaluator as JaxEvaluator
from twotower_tpu.features import text_encoder as jax_text
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.serving.index import RetrievalIndex as JaxIndex
from twotower_tpu.training.device_loop import make_epoch_fn as jax_make_epoch_fn
from twotower_tpu.training.loop import make_train_step as jax_make_train_step
from twotower_tpu.training.state import TrainState as JaxTrainState
from twotower_tpu.training.state import make_optimizer as jax_make_optimizer
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import Preprocessor, generate_interactions
from twotower_tpu_torch.data.prepare import write_artifacts
from twotower_tpu_torch.data.prepared import PreparedDataset
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.evaluation.evaluate import main as eval_main
from twotower_tpu_torch.features import text_encoder
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.serving import RetrievalIndex
from twotower_tpu_torch.training import make_optimizer, make_train_step
from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn
from twotower_tpu_torch.training.sparse import make_sparse_step_fn
from twotower_tpu_torch.training.train import main as train_main

NUM_USERS, NUM_ITEMS, BATCH, NEGS, BUCKETS, TOKENS = 1000, 500, 256, 64, 256, 8
OVERRIDES = {
    "model.embedding_dim": 32,
    "model.user_tower_dims": [64, 32],
    "model.item_tower_dims": [64, 32],
    "model.dropout_rate": 0.0,
    "model.compute_dtype": "float32",
    "model.text_buckets": BUCKETS,
    "model.text_tokens": TOKENS,
    "training.batch_size": BATCH,
    "retrieval.num_negatives": NEGS,
}
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
EMB_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def item_tokens(num_items=NUM_ITEMS, seed=3):
    """``[num_items, TOKENS]`` ids in [1, BUCKETS) with a ragged PAD tail per
    row (some rows all PAD)."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, BUCKETS, (num_items, TOKENS)).astype(np.int32)
    lengths = rng.integers(0, TOKENS + 1, num_items)
    tok[np.arange(TOKENS)[None, :] >= lengths[:, None]] = 0
    return tok


def _jax_params(jcfg, seed=0, num_users=NUM_USERS, num_items=NUM_ITEMS):
    jparams = jtt.init_params(jax.random.PRNGKey(seed), jcfg.model, num_users, num_items)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


# -- encoder ------------------------------------------------------------------

EDGE_TEXTS = np.array(
    ["Great quality, fast shipping", "", None, "great   QUALITY fast", 0, False, "naïve café",
     " ".join(f"w{i}" for i in range(40)), "one", "great quality, fast shipping"],
    dtype=object,
)


@pytest.mark.parametrize("buckets,tokens", [(1 << 16, 32), (7, 4), (2, 3)])
def test_encoder_matches_jax_bit_for_bit(buckets, tokens):
    ours = text_encoder.HashedNgramEncoder(num_buckets=buckets, max_tokens=tokens)
    ref = jax_text.HashedNgramEncoder(num_buckets=buckets, max_tokens=tokens)
    data = generate_interactions(num_users=40, num_items=30, num_interactions=400,
                                 with_text=True)
    texts = np.concatenate([EDGE_TEXTS[[0, 1, 3, 6, 7, 8, 9]], data.text])
    got = ours.encode(texts)
    assert got.dtype == np.int32 and got.shape == (len(texts), tokens)
    np.testing.assert_array_equal(got, ref.encode(texts))
    for t in EDGE_TEXTS:
        np.testing.assert_array_equal(ours.encode_one(t), ref.encode_one(t))


def test_encode_per_item_matches_jax_with_falsy_non_strings():
    ours, ref = text_encoder.HashedNgramEncoder(), jax_text.HashedNgramEncoder()
    rng = np.random.default_rng(5)
    n, items = 60, 12
    item_idx = rng.integers(-1, items + 1, n)  # out-of-range ids are skipped
    texts = EDGE_TEXTS[rng.integers(0, len(EDGE_TEXTS), n)]
    titles = EDGE_TEXTS[rng.integers(0, len(EDGE_TEXTS), n)]
    for tt in (None, titles):
        got = ours.encode_per_item(item_idx, texts, items, titles=tt)
        np.testing.assert_array_equal(got, ref.encode_per_item(item_idx, texts, items,
                                                               titles=tt))
        np.testing.assert_array_equal(got, ours.encode_per_item_slow(item_idx, texts, items,
                                                                     titles=tt))
        a, b = (text_encoder.select_first_item_texts(item_idx, texts, items, tt),
                jax_text.select_first_item_texts(item_idx, texts, items, tt))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]


# -- model --------------------------------------------------------------------


def test_pool_and_item_tower_with_tokens_match_jax():
    jcfg, cfg = JaxConfig().with_overrides(OVERRIDES), Config().with_overrides(OVERRIDES)
    jparams, params = _jax_params(jcfg, num_items=40)
    assert params["text_embedding"].shape == (two_tower.padded_rows(BUCKETS), 32)
    tok = item_tokens(40)
    rows = params["text_embedding"][_t(tok)]
    np.testing.assert_allclose(
        two_tower.pool_rows(rows, _t(tok)).numpy(),
        np.asarray(jtt.pool_rows(jparams["text_embedding"][tok], jnp.asarray(tok))), **EMB_TOL)
    np.testing.assert_allclose(two_tower.pool_text(params, _t(tok)).numpy(),
                               np.asarray(jtt.pool_text(jparams, jnp.asarray(tok))), **EMB_TOL)
    assert not two_tower.pool_text(params, _t(tok))[(tok == 0).all(1)].any()  # all-PAD rows
    idx = np.arange(40)[::-1].copy()
    np.testing.assert_allclose(
        two_tower.embed_items(params, _t(idx), cfg.model, text_tokens=_t(tok[idx])).numpy(),
        np.asarray(jtt.embed_items(jparams, jnp.asarray(idx), jcfg.model,
                                   text_tokens=jnp.asarray(tok[idx]))), **EMB_TOL)
    table = two_tower.embed_item_table(params, cfg.model, 40, chunk_size=16,
                                       item_tokens=_t(tok))
    np.testing.assert_allclose(
        table.numpy(),
        np.asarray(jtt.embed_item_table(jparams, jcfg.model, 40, chunk_size=64,
                                        item_tokens=jnp.asarray(tok))), **EMB_TOL)
    with pytest.raises(ValueError, match="no text tower"):
        no_text = {k: v for k, v in params.items() if k != "text_embedding"}
        two_tower.embed_items(no_text, _t(idx), cfg.model, text_tokens=_t(tok[idx]))


def test_text_embedding_init():
    cfg = Config().with_overrides(OVERRIDES)
    rows = two_tower.padded_rows(BUCKETS)
    init = np.random.default_rng(0).normal(size=(rows, 32)).astype(np.float32)
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 10, 10,
                                   text_embedding_init=init)
    np.testing.assert_array_equal(params["text_embedding"].numpy(), init)
    with pytest.raises(ValueError, match="text_embedding_init shape"):
        two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 10, 10,
                              text_embedding_init=init[:-1])


# -- train steps --------------------------------------------------------------


def _jax_neg_ids(step: int) -> np.ndarray:
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), step), 0x5E9)
    return np.asarray(jax.random.randint(key, (NEGS,), 0, NUM_ITEMS, dtype=jnp.int32))


def _batches(n, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"user_idx": rng.integers(0, NUM_USERS, BATCH).astype(np.int32),
             "item_idx": rng.integers(0, NUM_ITEMS, BATCH).astype(np.int32),
             "weight": np.ones(BATCH, np.float32)}
        b["weight"][-5:] = 0.0
        out.append(b)
    return out


def _assert_states_close(end, ref):
    for part in ("params", "table_state", "opt_state"):
        la, ta = jax.tree_util.tree_flatten(end[part])
        lb, tb = jax.tree_util.tree_flatten(ref[part])
        assert ta == tb, part
        for x, y in zip(la, lb):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), **TOL, err_msg=part)


@pytest.mark.parametrize("path,mode", [("sparse", "in_batch"), ("sparse", "mixed"),
                                       ("dense", "in_batch")])
def test_three_text_steps_match_jax(path, mode):
    over = {**OVERRIDES, "retrieval.candidate_sampling": mode,
            "training.sparse_table_updates": path == "sparse"}
    jcfg, cfg = JaxConfig().with_overrides(over), Config().with_overrides(over)
    jparams, _ = _jax_params(jcfg)
    jstate = JaxTrainState.for_config(jparams, jax_make_optimizer(jcfg.training), jcfg)
    start = jax_state_to_numpy(jstate)
    assert (start["table_state"] is not None) == (path == "sparse")
    tok = item_tokens()
    rows_i = start["params"]["item_embedding"].shape[0]
    log_q = np.log(np.random.default_rng(12).dirichlet(np.ones(rows_i)) + 1e-9).astype(np.float32)
    batches = _batches(3)

    jstep = jax_make_train_step(jcfg, jax_make_optimizer(jcfg.training), jnp.asarray(log_q),
                                item_tokens=jnp.asarray(tok), num_items=NUM_ITEMS)
    jmetrics = []
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(1))
        jmetrics.append({k: float(v) for k, v in m.items()})
    jax_end = jax_state_to_numpy(jstate)

    state = bridge.state_from_numpy(start, device="cpu")
    before = state.params["text_embedding"].clone()
    if mode == "in_batch":
        step = make_train_step(cfg, make_optimizer(cfg.training), log_q, item_tokens=tok,
                               num_items=NUM_ITEMS, device="cpu")
        run = lambda st, b, i: step(st, b, None)  # noqa: E731
    else:
        raw = make_sparse_step_fn(cfg, make_optimizer(cfg.training), num_items=NUM_ITEMS)
        run = lambda st, b, i: raw(  # noqa: E731
            st, {k: _t(v) for k, v in b.items()}, None, _t(log_q), _t(tok),
            neg_ids=_t(_jax_neg_ids(i)))
    for i, (b, jm) in enumerate(zip(batches, jmetrics)):
        state, m = run(state, b, i)
        for key in jm:
            np.testing.assert_allclose(float(m[key]), jm[key], **LOSS_TOL, err_msg=key)
    end = bridge.state_to_numpy(state)
    assert end["step"] == jax_end["step"] == 3
    _assert_states_close(end, jax_end)
    # The text table moved on the touched buckets, and the PAD row did not.
    moved = (state.params["text_embedding"] != before).any(dim=1)
    assert moved.sum() > 10 and not moved[0]


def test_text_device_loop_epochs_match_jax():
    """Two sparse device-loop epochs with item tokens against JAX's
    ``make_epoch_fn``, JAX's permutation handed over."""
    over = {**OVERRIDES, "training.warmup_steps": 3, "training.decay_steps": 10}
    jcfg, cfg = JaxConfig().with_overrides(over), Config().with_overrides(over)
    jparams, _ = _jax_params(jcfg)
    jstate = JaxTrainState.for_config(jparams, jax_make_optimizer(jcfg.training), jcfg)
    start = jax_state_to_numpy(jstate)
    tok = item_tokens()
    rng = np.random.default_rng(8)
    n = BATCH * 4
    users, items = rng.integers(0, NUM_USERS, n), rng.integers(0, NUM_ITEMS, n)
    ds = DeviceDataset(users, items, BATCH, device="cpu")
    jcols = {k: jnp.asarray(v.numpy()) for k, v in ds.columns.items()}
    jfn = jax_make_epoch_fn(jcfg, jax_make_optimizer(jcfg.training), ds.num_steps,
                            donate=False)
    fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, device="cpu")
    state = bridge.state_from_numpy(start, device="cpu")
    base = jax.random.PRNGKey(jcfg.training.seed + 1)
    for epoch in range(2):
        key = jax.random.fold_in(base, epoch)
        jstate, jm = jfn(jstate, jcols, key, None, jnp.asarray(tok))
        perm = np.asarray(jax.random.permutation(key, n))
        state, m = fn(state, ds.columns, epoch, None, _t(tok), perm=perm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    _assert_states_close(bridge.state_to_numpy(state), jax_state_to_numpy(jstate))


# -- evaluation, serving, prepared data ----------------------------------------


def test_evaluator_with_tokens_matches_jax():
    jcfg, cfg = JaxConfig().with_overrides(OVERRIDES), Config().with_overrides(OVERRIDES)
    jparams, params = _jax_params(jcfg, num_users=200, num_items=300)
    tok = item_tokens(300)
    rng = np.random.default_rng(4)
    users, items = rng.integers(0, 200, 250), rng.integers(0, 300, 250)
    ours = Evaluator(cfg, 300, batch_size=100, item_tokens=tok, device="cpu").evaluate(
        params, users, items)
    ref = JaxEvaluator(jcfg, 300, batch_size=100, item_tokens=tok).evaluate(jparams, users, items)
    assert ours.keys() == ref.keys()
    for key in ref:
        assert abs(ours[key] - ref[key]) <= 1.0 / len(users), key
    plain = Evaluator(cfg, 300, batch_size=100, device="cpu").evaluate(params, users, items)
    assert plain != ours  # the tokens move the corpus


@pytest.mark.parametrize("index_type,corpus_dtype", [("tpu_mips_exact", "float32"),
                                                     ("tpu_mips", "bfloat16")])
def test_retrieval_index_with_tokens_matches_jax(index_type, corpus_dtype):
    over = {**OVERRIDES, "serving.index_type": index_type, "serving.corpus_dtype": corpus_dtype}
    jcfg, cfg = JaxConfig().with_overrides(over), Config().with_overrides(over)
    jparams, params = _jax_params(jcfg, num_users=100, num_items=60)
    tok = item_tokens(60)
    jidx = JaxIndex(jcfg, jparams, 100, 60, item_tokens=tok)
    idx = RetrievalIndex(cfg, params, 100, 60, item_tokens=tok, device="cpu")
    users = np.arange(0, 100, 3, dtype=np.int32)
    assert_same_results(idx.recommend(users, k=10), jidx.recommend(users, k=10))
    items = np.arange(0, 60, 7, dtype=np.int32)
    assert_same_results(idx.similar_items(items, k=5), jidx.similar_items(items, k=5))


def test_build_item_tokens_matches_jax(tmp_path):
    cfg = Config().with_overrides({"preprocessing.min_interactions_per_user": 2,
                                   "preprocessing.min_interactions_per_item": 2})
    pp = Preprocessor(cfg.preprocessing)
    data = pp.process(generate_interactions(num_users=80, num_items=60, num_interactions=2000,
                                            with_text=True))
    write_artifacts(tmp_path / "prep", data, pp)
    encoder = text_encoder.HashedNgramEncoder(num_buckets=BUCKETS, max_tokens=TOKENS)
    ours = PreparedDataset(tmp_path / "prep", batch_rows=97)
    ref = JaxPreparedDataset(tmp_path / "prep", batch_rows=97)
    assert ours.has_text and ours.build_item_tokens(None) is None
    got = ours.build_item_tokens(encoder)
    want = ref.build_item_tokens(jax_text.HashedNgramEncoder(num_buckets=BUCKETS,
                                                             max_tokens=TOKENS))
    assert got.shape == (ours.num_items, TOKENS) and (got != 0).any()
    np.testing.assert_array_equal(got, want)
    # The in-memory path's per-item table: the same first texts.
    np.testing.assert_array_equal(
        got, encoder.encode_per_item(data.item_idx, data.text, ours.num_items,
                                     titles=data.title))


# -- CLI ------------------------------------------------------------------------

CLI_DATA = ["--synthetic", "--synthetic-users", "200", "--synthetic-items", "100",
            "--synthetic-interactions", "5000"]
CLI_OVERRIDES = [
    "training.batch_size=64", "training.epochs=2", "model.embedding_dim=16",
    "model.user_tower_dims=[32,16]", "model.item_tower_dims=[32,16]",
    "model.text_buckets=512", "model.text_tokens=8",
    "preprocessing.min_interactions_per_user=2", "preprocessing.min_interactions_per_item=2",
]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("exec_rung", ["host", "device-loop"])
def test_synthetic_text_train_evaluate_serve(tmp_path, capsys, exec_rung):
    ckpt = tmp_path / "ckpt"
    args = [*CLI_DATA, "--device", "cpu", "--checkpoint-dir", str(ckpt)]
    assert train_main(args + ["--synthetic-text", "--exec", exec_rung, "--writers", "jsonl",
                              "--override", *CLI_OVERRIDES]) == 0
    summary = _last_json(capsys)
    with np.load(ckpt / "item_tokens.npz") as f:
        tokens = f["tokens"]
    assert tokens.shape == (summary["num_items"], 8) and tokens.dtype == np.int32
    assert (tokens != 0).any(axis=1).all()  # every item has its first text
    assert json.loads((ckpt / "config.json").read_text())["model"]["text_buckets"] == 512
    assert eval_main(args + ["--subset", "test"]) == 0
    ev = _last_json(capsys)
    assert ev["checkpoint_step"] == summary["best_step"]
    if summary["best_step"] == json.loads(
            (ckpt / "metrics.jsonl").read_text().splitlines()[-1])["step"]:
        for k, v in summary["test"].items():
            assert abs(ev["metrics"][k] - v) <= 1e-6, k
    # The exact index over the saved tokens serves the evaluation's ranking.
    from twotower_tpu_torch.config import load_config_for_checkpoint
    from twotower_tpu_torch.ops.topk import topk_mips_twopass

    cfg = load_config_for_checkpoint(ckpt).with_overrides(
        {"serving.index_type": "tpu_mips_exact", "serving.corpus_dtype": "float32"})
    index = RetrievalIndex.from_checkpoint(cfg, ckpt, device="cpu")
    evaluator = Evaluator(cfg, index.num_items, item_tokens=tokens, device="cpu")
    users = np.arange(min(64, index.num_users))
    with torch.no_grad():
        emb = two_tower.embed_users(index.params, _t(users), cfg.model)
        ref_v, ref_i = topk_mips_twopass(emb, evaluator._encode_corpus(index.params), 10,
                                         chunk_size=evaluator.corpus_chunk_size)
    vals, ids = index.recommend(users, 10)
    np.testing.assert_array_equal(ids, ref_i.numpy())
    np.testing.assert_array_equal(vals, ref_v.numpy())


def test_transformer_text_encoder_exits_naming_roadmap(tmp_path, capsys):
    """The transformer encoder is ported (``tests/test_torch_transformer_encoder.py``):
    train-model no longer exits naming the ROADMAP item. A model directory
    that does not exist now fails where the JAX CLI fails, loading the
    tokenizer, with the same exception type."""
    from twotower_tpu.training.train import main as jax_train_main

    args = [*CLI_DATA, "--synthetic-text", "--override", *CLI_OVERRIDES,
            "model.text_encoder=transformer", "model.text_model_path=/nonexistent"]
    with pytest.raises(Exception) as jax_err:
        jax_train_main([*args, "--checkpoint-dir", str(tmp_path / "j")])
    with pytest.raises(Exception) as e:
        train_main([*args, "--device", "cpu", "--checkpoint-dir", str(tmp_path / "c")])
    assert type(e.value) is type(jax_err.value) and not isinstance(e.value, SystemExit)
    assert "/nonexistent" in str(e.value) and "ROADMAP" not in str(e.value)

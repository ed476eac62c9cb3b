"""The port's ``RetrievalIndex`` against the JAX package's, built from the
same parameters (the JAX init through the bridge), for every
``serving.index_type`` x ``serving.corpus_dtype`` that ``ServingConfig``
allows; its corpus export; and ``from_checkpoint`` on checkpoints the port
wrote.

Setting: embedding 16, towers [32,16], float32 compute (bf16-rounded
towers would differ by up to 2e-2, ``test_torch_two_tower.py``), 100 users
and 60 items (the JAX serving tests' index) and a 3,000-item index whose
approximate search runs blocked (``item_chunk`` 1024).

Tolerances: scores rtol 1e-5 (float32 towers and products that differ in
summation order only). Ids are equal except between exactly tied scores,
which int8 corpora produce (integer scores): where the ids differ, the
port's id holds the reference score of that rank in the reference's
list, or ties the reference's last score.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.ops.topk import topk_mips_approx as jax_approx
from twotower_tpu.serving.index import RetrievalIndex as JaxIndex
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops.topk import ann_padded_rows, topk_mips_approx
from twotower_tpu_torch.serving import RetrievalIndex

WIDTHS = {
    "model.embedding_dim": 16,
    "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
    "model.compute_dtype": "float32",
}
# Every (index_type, corpus_dtype) ServingConfig allows, "auto" resolved.
INDEXES = [
    ("tpu_mips", "bfloat16"),
    ("tpu_mips", "float32"),
    ("tpu_mips", "int8"),
    ("tpu_mips", "int8_rowscale"),
    ("tpu_mips_exact", "float32"),
    ("cpu_flat", "float32"),
]
SCORE_TOL = dict(rtol=1e-5, atol=1e-7)


def _configs(index_type, corpus_dtype, extra=None):
    over = {**WIDTHS, "serving.index_type": index_type, "serving.corpus_dtype": corpus_dtype,
            **(extra or {})}
    return JaxConfig().with_overrides(over), Config().with_overrides(over)


def _params(jcfg, num_users, num_items, seed=0):
    jparams = jtt.init_params(jax.random.PRNGKey(seed), jcfg.model, num_users, num_items)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


def _pair(index_type, corpus_dtype, num_users=100, num_items=60, seed=0):
    jcfg, cfg = _configs(index_type, corpus_dtype)
    jparams, params = _params(jcfg, num_users, num_items, seed)
    return (JaxIndex(jcfg, jparams, num_users, num_items),
            RetrievalIndex(cfg, params, num_users, num_items, device="cpu"))


def assert_same_results(ours, ref):
    (v, i), (rv, ri) = ours, ref
    assert v.shape == rv.shape and i.dtype == np.int32
    np.testing.assert_allclose(v, rv, **SCORE_TOL)
    for r in range(len(i)):
        for j in np.nonzero(i[r] != ri[r])[0]:
            tied = rv[r] == rv[r, j]
            assert i[r, j] in ri[r][tied] or (tied[-1] and i[r, j] not in ri[r]), (r, j)
        assert len(set(i[r])) == i.shape[1]


@pytest.fixture(scope="module", params=INDEXES, ids=lambda p: "-".join(p))
def index_pair(request):
    return _pair(*request.param)


def test_recommend_matches_jax(index_pair):
    jidx, idx = index_pair
    users = np.arange(0, 100, 3, dtype=np.int32)
    assert_same_results(idx.recommend(users, k=10), jidx.recommend(users, k=10))


def test_recommend_by_history_matches_jax(index_pair):
    jidx, idx = index_pair
    hist = np.array([[3, 7, 9, -1, -1], [0, -1, -1, -1, -1], [5, 11, 12, 40, 59]])
    assert_same_results(idx.recommend_by_history(hist, k=8), jidx.recommend_by_history(hist, k=8))


def test_similar_items_matches_jax(index_pair):
    jidx, idx = index_pair
    items = np.array([3, 7, 0, 59], np.int32)
    v, i = idx.similar_items(items, k=5)
    assert_same_results((v, i), jidx.similar_items(items, k=5))
    assert not (i == items[:, None]).any()


def test_recommend_by_embedding_matches_jax(index_pair):
    jidx, idx = index_pair
    emb = np.random.default_rng(0).normal(size=(6, 16)).astype(np.float32)
    assert_same_results(idx.recommend_by_embedding(emb, k=7),
                        jidx.recommend_by_embedding(emb, k=7))


def test_resident_corpus_matches_jax(index_pair):
    """The resident corpus: dtype, rows, and values (int8 values may sit
    one step apart where a float32 tower output lands on a rounding
    boundary)."""
    jidx, idx = index_pair
    ref = np.asarray(jidx.corpus)
    ours = idx.corpus.float().numpy()
    assert idx.corpus.shape == ref.shape
    assert str(idx.corpus.dtype).removeprefix("torch.") == ref.dtype.name
    if idx.quantized:
        assert np.abs(ours - ref.astype(np.float32)).max() <= 1
        np.testing.assert_allclose(idx.corpus_scale.numpy(), np.asarray(jidx.corpus_scale),
                                   rtol=1e-5)
    else:
        np.testing.assert_allclose(ours, ref.astype(np.float32), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("corpus_dtype", ["bfloat16", "int8", "int8_rowscale"])
def test_blocked_search_matches_jax(corpus_dtype):
    """The blocked branch on an index's resident corpus: 3,000 items in
    three 1,024-row blocks (16-row query chunks: 16 x 3,000 > 16 x 1,024),
    then the index's own single-shot search."""
    jcfg, cfg = _configs("tpu_mips", corpus_dtype)
    jparams, params = _params(jcfg, 50, 3000, seed=2)
    jidx = JaxIndex(jcfg, jparams, 50, 3000)
    idx = RetrievalIndex(cfg, params, 50, 3000, device="cpu")
    emb = np.random.default_rng(1).normal(size=(40, 16)).astype(np.float32)
    kw = dict(query_chunk=16, item_chunk=1024, num_valid=3000)
    rv, ri = jax_approx(jnp.asarray(emb), jidx.corpus, 20, item_scale=jidx.corpus_scale, **kw)
    v, i = topk_mips_approx(torch.from_numpy(emb), idx.corpus, 20,
                            item_scale=idx.corpus_scale, **kw)
    assert_same_results((v.numpy(), i.to(torch.int32).numpy()), (np.asarray(rv), np.asarray(ri)))
    assert_same_results(idx.recommend(np.arange(50), k=20), jidx.recommend(np.arange(50), k=20))


@pytest.mark.parametrize("corpus_dtype", ["float32", "bfloat16", "int8", "int8_rowscale"])
def test_export_corpus_round_trip(tmp_path, corpus_dtype):
    """The export is the dequantized resident corpus, and within half a
    quantization step (or the bf16 rounding) of the float32 corpus."""
    _, cfg = _configs("tpu_mips", corpus_dtype)
    _, params = _params(JaxConfig().with_overrides(WIDTHS), 50, 40, seed=1)
    idx = RetrievalIndex(cfg, params, 50, 40, device="cpu")
    idx.export_corpus(tmp_path / "corpus.npz")
    with np.load(tmp_path / "corpus.npz") as data:
        exported = data["corpus"]
    full = two_tower.embed_item_table(params, cfg.model, 40).numpy()
    assert exported.shape == (40, 16) and exported.dtype == np.float32
    if idx.quantized:
        scale = idx.corpus_scale.numpy()
        deq = idx.corpus.numpy().astype(np.float32) * (scale[:, None] if scale.ndim else scale)
        np.testing.assert_array_equal(exported, deq)
        half_step = (scale[:, None] if scale.ndim else scale) / 2
        assert (np.abs(exported - full) <= half_step * (1 + 1e-6)).all()
    else:
        np.testing.assert_array_equal(exported, idx.corpus.float().numpy())
        np.testing.assert_allclose(exported, full, rtol=2.0**-8 if corpus_dtype == "bfloat16"
                                   else 0.0, atol=0.0)


def test_padding_to_the_search_layout():
    """2^21 + 3 items is past one item block: the corpus is padded once to
    the blocked layout (ann_padded_rows) and the padding never surfaces.
    Two users and one-layer towers keep the test small."""
    _, cfg = _configs("tpu_mips", "int8", {"model.user_tower_dims": [16],
                                           "model.item_tower_dims": [16]})
    n = (1 << 21) + 3
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 2, n)
    idx = RetrievalIndex(cfg, params, 2, n, device="cpu")
    assert idx.corpus.shape[0] == ann_padded_rows(n) > n
    _, i = idx.recommend(np.array([0, 1]), k=5)
    assert i.max() < n


def test_from_checkpoint_records_step_and_pins(tmp_path):
    """Two steps saved by the port's CheckpointManager with different
    params: the default restores the best-metric step (evaluate-model's
    rule), ``step=`` pins the other."""
    from twotower_tpu_torch.data.vocab import VocabPair, Vocabulary
    from twotower_tpu_torch.training import TrainState, make_optimizer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    _, cfg = _configs("tpu_mips", "auto")
    opt = make_optimizer(cfg.training)
    manager = CheckpointManager(tmp_path, keep=3)
    VocabPair(
        users=Vocabulary.build(np.array([f"U{i}" for i in range(20)], object)),
        items=Vocabulary.build(np.array([f"I{i}" for i in range(30)], object)),
    ).save(tmp_path / "vocab")
    for step, seed, recall in ((3, 0, 0.5), (9, 1, 0.2)):
        params = two_tower.init_params(torch.Generator().manual_seed(seed), cfg.model, 20, 30)
        manager.save(step, TrainState.for_config(params, opt, cfg),
                     metrics={"val/recall@10": recall})
    best = RetrievalIndex.from_checkpoint(cfg, tmp_path, device="cpu")
    assert best.checkpoint_step == 3 and len(best.vocab.items) == 30
    pinned = RetrievalIndex.from_checkpoint(cfg, tmp_path, step=9, device="cpu")
    assert pinned.checkpoint_step == 9
    assert not torch.allclose(best.corpus.float(), pinned.corpus.float())
    assert best.corpus.dtype == torch.bfloat16  # "auto" under tpu_mips


def test_unported_options_raise(tmp_path):
    _, cfg = _configs("tpu_mips", "auto")
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 5, 5)
    with pytest.raises(NotImplementedError, match="Sharded serving and the scaling tools"):
        RetrievalIndex(cfg, params, 5, 5, mesh=object(), device="cpu")
    # Item tokens need a model with a text tower (as in the JAX index).
    with pytest.raises(ValueError, match="no text tower"):
        RetrievalIndex(cfg, params, 5, 5, item_tokens=np.zeros((5, 2), np.int32), device="cpu")
    idx = RetrievalIndex(cfg, params, 5, 5, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        idx.recommend(np.array([5]), k=2)
    with pytest.raises(ValueError, match="out of range"):
        idx.similar_items(np.array([-1]), k=2)

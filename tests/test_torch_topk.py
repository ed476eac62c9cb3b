"""The port's exact search (``ops/topk.py``), retrieval metrics and corpus
encode against the JAX package.

Tolerances: both sides compute float32 inner products (the JAX side at
``Precision.HIGHEST``), differing only in summation order, so scores agree to
rtol 1e-6 / atol 1e-6 and ids are equal wherever scores are not exactly tied.
The metrics are float32 means of the same ranks: rtol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_two_tower import TOL as TOWER_TOL
from test_torch_two_tower import _bridged, _configs
from twotower_tpu.evaluation import metrics as jmetrics
from twotower_tpu.models import two_tower as jtt
from twotower_tpu.ops import topk as jtopk
from twotower_tpu_torch.evaluation import metrics
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops import topk
from twotower_tpu_torch.ops.precision import float32_products, matmul_tf32

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(batch, n, dim=32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(batch, dim)).astype(np.float32)
    c = rng.normal(size=(n, dim)).astype(np.float32)
    return q, c


def _ours(fn, q, c, k, **kw):
    v, i = fn(torch.from_numpy(q), torch.from_numpy(c), k, **kw)
    return v.numpy(), i.numpy()


def _ref(fn, q, c, k, **kw):
    v, i = fn(jnp.asarray(q), jnp.asarray(c), k, **kw)
    return np.asarray(v), np.asarray(i)


@pytest.mark.parametrize(
    "batch,n,k,kw",
    [
        (40, 5000, 10, {}),  # two-pass core: n > 4 k block
        (40, 5000, 10, {"num_valid": 4701}),  # ragged last block, padding rows
        (300, 6000, 7, {"row_slab": 128}),  # JAX's batch not a multiple of row_slab
        (40, 5000, 10, {"chunk_size": 1024}),  # several pass-1 chunks
        (33, 900, 10, {}),  # small-corpus fallback to the scan
        (33, 900, 10, {"num_valid": 700}),
    ],
)
def test_twopass_matches_jax(batch, n, k, kw):
    q, c = _inputs(batch, n)
    v, i = _ours(topk.topk_mips_twopass, q, c, k,
                 **{key: val for key, val in kw.items() if key != "row_slab"})
    rv, ri = _ref(jtopk.topk_mips_twopass, q, c, k, **kw)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(v, rv, **SCORE_TOL)
    assert i.max() < kw.get("num_valid", n)  # padding rows never surface


@pytest.mark.parametrize("kw", [{}, {"num_valid": 3000, "chunk_size": 512}])
def test_scan_matches_jax(kw):
    q, c = _inputs(24, 3100, seed=1)
    v, i = _ours(topk.topk_mips, q, c, 20, **kw)
    rv, ri = _ref(jtopk.topk_mips, q, c, 20, **kw)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(v, rv, **SCORE_TOL)


@pytest.mark.parametrize("search", ["topk_mips", "topk_mips_twopass"])
def test_planted_ties(search):
    """Exact ties: equal scores; the ids agree outside the tied ranks, and
    inside them both return a set of equally scored ids."""
    q, c = _inputs(8, 5000, seed=2)
    c[100:140] = c[7]  # 41 identical rows: one score tied across all of them
    k = 12
    v, i = _ours(getattr(topk, search), q, c, k)
    rv, ri = _ref(getattr(jtopk, search), q, c, k)
    np.testing.assert_allclose(v, rv, **SCORE_TOL)
    tied = set(range(100, 140)) | {7}
    for row in range(len(q)):
        for a, b in zip(i[row], ri[row]):
            assert a == b or (a in tied and b in tied)
        assert len(set(i[row])) == k  # no id twice


def test_twopass_scores_are_the_products():
    """The kept scores are the chunk product's own: equal, bit for bit, to
    one full product and its top-k."""
    q, c = _inputs(64, 9000, seed=5)
    v, i = _ours(topk.topk_mips_twopass, q, c, 10, chunk_size=4096)
    full = torch.from_numpy(q) @ torch.from_numpy(c[:4096]).T
    rest = torch.from_numpy(q) @ torch.from_numpy(c[4096:8192]).T
    tail = torch.from_numpy(q) @ torch.from_numpy(c[8192:]).T
    ref_v, ref_i = torch.topk(torch.cat([full, rest, tail], dim=1), 10, dim=1)
    np.testing.assert_array_equal(v, ref_v.numpy())
    np.testing.assert_array_equal(i, ref_i.numpy())


def test_chunk_rules_match_jax():
    for b in (1, 256, 4096, 16384, 1 << 20):
        assert topk.exact_scan_chunk(b) == jtopk.exact_scan_chunk(b)
    for n in (5, 1 << 20, (1 << 20) + 1, 10_000_000):
        assert topk.exact_padded_rows(n) == jtopk.exact_padded_rows(n)


def test_bad_arguments_raise():
    q, c = torch.zeros(2, 4), torch.zeros(10, 4)
    with pytest.raises(ValueError, match="num_valid"):
        topk.topk_mips_twopass(q, c, 3, num_valid=11)
    with pytest.raises(ValueError, match="exceeds corpus"):
        topk.topk_mips(q, c, 11)


def test_tf32_is_off_inside_and_restored():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with float32_products():
            assert not matmul_tf32()
        assert torch.backends.cuda.matmul.allow_tf32
        with pytest.raises(RuntimeError, match="TF32"):
            topk._chunk_scores(torch.zeros(1, 2), torch.zeros(3, 2), 0, 3, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_at_k_matches_jax(weighted):
    """The same top-k ids in; rows whose true item is absent (rank k)."""
    rng = np.random.default_rng(4)
    idx = np.stack([rng.permutation(50)[:20] for _ in range(64)]).astype(np.int32)
    true = rng.integers(0, 50, 64).astype(np.int32)
    w = (rng.random(64) > 0.3).astype(np.float32) if weighted else None
    ks = (1, 5, 10, 20)
    ours = metrics.metrics_at_k(
        torch.from_numpy(idx), torch.from_numpy(true), ks,
        weights=None if w is None else torch.from_numpy(w),
    )
    ref = jmetrics.metrics_at_k(jnp.asarray(idx), jnp.asarray(true), ks,
                                weights=None if w is None else jnp.asarray(w))
    assert ours.keys() == ref.keys()
    for key in ref:
        np.testing.assert_allclose(float(ours[key]), float(ref[key]), rtol=1e-6, err_msg=key)
    np.testing.assert_array_equal(
        metrics.rank_of_true_item(torch.from_numpy(idx), torch.from_numpy(true)).numpy(),
        np.asarray(jmetrics.rank_of_true_item(jnp.asarray(idx), jnp.asarray(true))),
    )
    assert (np.asarray(jmetrics.rank_of_true_item(jnp.asarray(idx), jnp.asarray(true))) == 20).any()


def test_merge_metric_sums_matches_jax():
    batches = [{"recall@10": 0.5, "mrr": 0.25}, {"recall@10": 0.1, "mrr": 0.75}]
    weights = [3.0, 1.0]
    ours = metrics.merge_metric_sums(
        [{k: torch.tensor(v) for k, v in b.items()} for b in batches], weights
    )
    ref = jmetrics.merge_metric_sums(batches, weights)
    for key in ref:
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-6)
    assert metrics.merge_metric_sums([], []) == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_item_table_matches_jax(dtype):
    """One set of params through both packages (tolerances of
    test_torch_two_tower.py); a chunk smaller than the table."""
    jcfg, cfg = _configs(dtype)
    jparams, params = _bridged(jcfg)
    ref = np.asarray(jtt.embed_item_table(jparams, jcfg.model, 200, chunk_size=64))
    ours = two_tower.embed_item_table(params, cfg.model, 200, chunk_size=64)
    assert ours.shape == ref.shape == (200, 32)
    np.testing.assert_allclose(ours.numpy(), ref, **TOWER_TOL[dtype])

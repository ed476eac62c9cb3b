"""The port's serving search (``ops/topk.py``: ``quantize_corpus``,
``topk_mips_approx``, the block layout) against the JAX package on the CPU,
where ``lax.approx_max_k`` is an exact top-k, for a float32, bfloat16, int8
and int8_rowscale corpus; and ``float32_products()`` under threads.

Tolerances: quantization is the same float32 arithmetic on both sides, so
the int8 values are bit-equal and the scales within rtol 1e-7. Scores
within rtol 1e-5: float32 and bfloat16 products differ in summation order
only, and an int8 score is the same integer times float32 scales multiplied
in another order. int8 raw scores are recomputed exactly in numpy at the ids
each side returns and must be equal as integers, position by position, so
ids may differ only between exactly tied scores (common at int8 precision).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.ops import topk as jtopk
from twotower_tpu_torch.ops import topk
from twotower_tpu_torch.ops.precision import float32_products, matmul_tf32

VARIANTS = ["float32", "bfloat16", "int8", "int8_rowscale"]
BRANCHES = {
    "single_shot": {},
    "blocked": {"item_chunk": 512, "query_chunk": 16},  # 3000 rows in 6 blocks
    "num_valid": {"num_valid": 2901, "item_chunk": 512},  # ragged last block, padding rows
}
SCORE_TOL = dict(rtol=1e-5, atol=0)


def _data(b=40, n=3000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(n, d)).astype(np.float32))


def _corpora(c, variant):
    """The same corpus, resident as ``variant``, for JAX and for the port."""
    if variant == "float32":
        return (jnp.asarray(c), None), (torch.from_numpy(c), None)
    if variant == "bfloat16":
        return (jnp.asarray(c).astype(jnp.bfloat16), None), (torch.from_numpy(c).bfloat16(), None)
    per_row = variant == "int8_rowscale"
    return (jtopk.quantize_corpus(jnp.asarray(c), per_row=per_row),
            topk.quantize_corpus(torch.from_numpy(c), per_row=per_row))


def _int8_exact(q, corpus_q, corpus_scale, ids):
    """Raw integer scores at ``ids`` (numpy int64) and the float32 values
    both packages return for them."""
    qq, qs = (t.numpy() for t in topk._quantize_queries(torch.from_numpy(q)))
    cq = corpus_q.numpy().astype(np.int64)
    raw = np.einsum("bd,bkd->bk", qq.astype(np.int64), cq[ids])
    scale = corpus_scale.numpy()
    if scale.ndim:
        return raw, raw.astype(np.float32) * scale[ids] * qs[:, None]
    return raw, raw.astype(np.float32) * (qs[:, None] * scale)


def _check_same_topk(q, ours, ref, port_corpus, variant):
    (v, i), (rv, ri) = ours, ref
    np.testing.assert_allclose(v, rv, **SCORE_TOL)
    if variant.startswith("int8"):
        raw, want = _int8_exact(q, *port_corpus, i)
        raw_ref, want_ref = _int8_exact(q, *port_corpus, ri)
        # Equal integers at every rank: where the ids differ, they tie.
        np.testing.assert_array_equal(raw, raw_ref)
        np.testing.assert_allclose(v, want, rtol=1e-6)
        np.testing.assert_allclose(rv, want_ref, rtol=1e-6)
    else:
        np.testing.assert_array_equal(i, ri)  # no exact ties in gaussian data


@pytest.mark.parametrize("per_row", [False, True])
def test_quantize_corpus_matches_jax(per_row):
    _, c = _data()
    c[7] = 0.0  # an all-zero row: scale 0, q 0
    jq, js = jtopk.quantize_corpus(jnp.asarray(c), per_row=per_row)
    q, s = topk.quantize_corpus(torch.from_numpy(c), per_row=per_row)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(s.shape) == np.shape(js)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-7, atol=0)
    qq, qs = topk._quantize_queries(torch.from_numpy(c[:64]))
    jqq, jqs = jtopk._quantize_queries(jnp.asarray(c[:64]))
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
    np.testing.assert_allclose(qs.numpy(), np.asarray(jqs), rtol=1e-7, atol=0)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("variant", VARIANTS)
def test_approx_matches_jax(variant, branch):
    q, c = _data()
    kw = BRANCHES[branch]
    (jc, js), (tc, ts) = _corpora(c, variant)
    rv, ri = jtopk.topk_mips_approx(jnp.asarray(q), jc, 10, item_scale=js, **kw)
    v, i = topk.topk_mips_approx(torch.from_numpy(q), tc, 10, item_scale=ts, **kw)
    assert v.dtype == torch.float32 and v.shape == i.shape == (40, 10)
    _check_same_topk(q, (v.numpy(), i.numpy()), (np.asarray(rv), np.asarray(ri)), (tc, ts),
                     variant)
    assert i.max() < kw.get("num_valid", len(c))


@pytest.mark.parametrize("variant", VARIANTS)
def test_padding_rows_never_surface(variant):
    """Rows past ``num_valid`` would win every query if scored."""
    q, c = _data(b=8, n=1000, seed=1)
    c[900:] = 50.0 * np.abs(q).mean(0)  # aligned with every query
    (_, _), (tc, ts) = _corpora(c, variant)
    if ts is not None and ts.dim() == 0:  # the huge rows set the global scale
        tc, ts = topk.quantize_corpus(torch.from_numpy(c[:900]))
        tc = torch.cat([tc, torch.full((100, c.shape[1]), 127, dtype=torch.int8)])
    _, i = topk.topk_mips_approx(torch.from_numpy(q), tc, 20, num_valid=900, item_scale=ts)
    assert i.max() < 900


@pytest.mark.parametrize("depth", [16, 20])
@pytest.mark.parametrize("rows", [5, 8, 27, 64])
@pytest.mark.parametrize("batch", [1, 17, 40])
def test_int8_scores_are_exact_integers(batch, rows, depth):
    """``torch._int_mm`` (depth 16, with its padding of few query rows and
    ragged corpus rows) and the bf16 route (depth 20) both give the numpy
    integer product."""
    rng = np.random.default_rng(batch * rows + depth)
    qq = rng.integers(-127, 128, (batch, depth)).astype(np.int8)
    cq = rng.integers(-127, 128, (rows, depth)).astype(np.int8)
    got = topk._int8_scores(torch.from_numpy(qq), torch.from_numpy(cq))
    assert got.shape == (batch, rows)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  qq.astype(np.int64) @ cq.astype(np.int64).T)


def test_int8_depth_with_no_exact_route_raises():
    with pytest.raises(ValueError, match="depth 1041"):
        topk._int8_scores(torch.zeros(2, 1041, dtype=torch.int8),
                          torch.zeros(3, 1041, dtype=torch.int8))


def test_layout_rules_match_jax():
    for n in (1, 100, 2048, 99_978, 1 << 21, (1 << 21) + 1, 4_500_001, 10_000_000, 12_345_678):
        for k in (1, 100, 2048):
            assert topk.ann_padded_rows(n, k=k) == jtopk.ann_padded_rows(n, k=k), (n, k)
            for chunk in (512, 1 << 21):
                assert topk._blocked_layout(n, chunk, k) == jtopk._blocked_layout(n, chunk, k)
    assert topk._blocked_layout(10_000_000, 1 << 21, 100) == (5, 2_000_000)


@pytest.mark.parametrize("search", ["approx", "scan"])
def test_bf16_scores_are_not_rounded(search):
    """A bfloat16 corpus's top-k scores equal the float32 product of the
    bf16 values within rtol 1e-6 (a bf16-rounded score is off by up to
    2^-9 relative)."""
    q, c = _data(b=16, n=2000, d=32, seed=3)
    qb, cb = torch.from_numpy(q).bfloat16(), torch.from_numpy(c).bfloat16()
    if search == "approx":
        v, i = topk.topk_mips_approx(torch.from_numpy(q), cb, 20)
    else:
        v, i = topk.topk_mips(torch.from_numpy(q), cb, 20)
    exact = np.einsum("bd,bkd->bk", qb.double().numpy(), cb.double().numpy()[i.numpy()])
    assert v.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), exact, rtol=1e-6, atol=0)
    assert not np.array_equal(v.numpy(), v.bfloat16().float().numpy())


def test_bad_arguments_raise():
    q, c = torch.zeros(2, 8), torch.zeros(10, 8)
    cq, s = topk.quantize_corpus(c)
    with pytest.raises(ValueError, match="requires item_scale"):
        topk.topk_mips_approx(q, cq, 3)
    with pytest.raises(ValueError, match="not int8"):
        topk.topk_mips_approx(q, c, 3, item_scale=s)
    with pytest.raises(ValueError, match="shape"):
        topk.topk_mips_approx(q, cq, 3, item_scale=torch.ones(3))
    with pytest.raises(ValueError, match="recall_target"):
        topk.topk_mips_approx(q, c, 3, recall_target=0.0)
    with pytest.raises(ValueError, match="exceeds corpus"):
        topk.topk_mips_approx(q, c, 4, num_valid=3)
    with pytest.raises(TypeError, match="int8"):
        topk.topk_mips(q, cq, 3)
    v, i = topk.topk_mips_approx(torch.zeros(0, 8), c, 3)
    assert v.shape == i.shape == (0, 3)


def test_tf32_stays_off_while_any_thread_is_inside():
    """Two threads enter and leave interleaved (A in, B in, A out, B's
    product, B out) with the caller's setting True: B's product never sees
    TF32 on, and the setting comes back once both have left."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    steps = {name: threading.Event() for name in ("a_in", "b_in", "a_out")}
    seen, errors = [], []

    def thread_a():
        with float32_products():
            steps["a_in"].set()
            steps["b_in"].wait(5)
        steps["a_out"].set()

    def thread_b():
        steps["a_in"].wait(5)
        with float32_products():
            steps["b_in"].set()
            steps["a_out"].wait(5)
            seen.append(matmul_tf32())
            try:
                topk._chunk_scores(torch.ones(1, 2), torch.ones(3, 2), 0, 3, 3)
            except RuntimeError as e:  # raised if TF32 were back on
                errors.append(e)

    try:
        threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        assert all(steps[s].is_set() for s in steps)
        assert seen == [False] and not errors
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_tf32_guard_under_thread_stress():
    """Many threads searching at once with a short switch interval: no
    search raises for TF32 on, and the caller's setting is restored."""
    import sys

    prev, interval = torch.backends.cuda.matmul.allow_tf32, sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    sys.setswitchinterval(1e-6)
    q, c = torch.randn(4, 8), torch.randn(300, 8)
    errors = []

    def work():
        try:
            for _ in range(20):
                topk.topk_mips(q, c, 5, chunk_size=128)
        except RuntimeError as e:
            errors.append(e)

    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads), time.perf_counter() - t0
        assert not errors
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = prev

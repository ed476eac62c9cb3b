"""The block-maxima prefilter (``ops/prefilter.py``) in both precisions: the
approx search's over a bfloat16 corpus and the exact two-pass search's over
a float32 one. On the CPU the plain versions, the rule that picks each path,
the span, the budget, the cover argument under planted ties and
``topk_mips_twopass``'s CPU results unchanged (the chunked scan of the
blocks); on the card (``cuda`` tests) the kernels against their plain
versions, bit for bit against themselves.

bfloat16: the full select here is one product of the upcast operands, the
plain version's the same product in other chunks: scores within rtol 1e-6
(float32 sums of the same exact products in another blocking), and ids
equal except between scores that tie exactly (bf16 rows of depth 16 tie now
and then even in float64). Planted equal scores are compared as sets.

float32: three TF32 passes of split operands summed in float32: the plain
versions within ``REL`` times ``|q| . |c|`` (the sum of the products'
magnitudes) of the float64 product (the split leaves about 3 x 2^-22 of each
product out, the float32 sums add theirs; they read 2.1e-7 to 3.7e-7 of it
at depths 8 to 256 here), the kernels within ``KERNEL_REL`` (48 MMAs a score
at depth 128, each rounding toward zero by at most a float32 ulp of a
partial sum, and the split's 3 x 2^-22; they read about 1.1e-6 on the H100).
Ids equal the float64 top-k's except between scores within that tolerance.
On the CPU ``topk_mips_twopass`` keeps its chunked scan, so the tests that
drive it through the prefilter force the route onto the plain versions
(``forced``).

This file imports no JAX, so that the card runs its ``cuda`` tests with
``--noconftest``.
"""

import ctypes
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from twotower_tpu_torch.ops import build, kernels, prefilter, topk
from twotower_tpu_torch.ops.precision import float32_products
from twotower_tpu_torch.utils import profiling

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)
REL = 2e-6
KERNEL_REL = 48 * 2.0**-23 + 3 * 2.0**-22
BLOCK = prefilter.BLOCK
N = 30_011  # ragged: 469 blocks of 64 and 59 rows over; more than 4 x 100 blocks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _force(monkeypatch):
    """``topk_mips_twopass`` takes the float32 prefilter on the CPU too (the
    plain versions), wherever ``prefilter.F32.applies``."""
    monkeypatch.setattr(topk, "_on_the_float32_prefilter",
                        lambda emb, k, block, n_real: prefilter.F32.applies(emb, k, n_real))


@pytest.fixture()
def forced(monkeypatch):
    _force(monkeypatch)


def _data(b, n=N, d=16, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    return q, c


def _full_select(q, c, k, n_real=None):
    """The select the bfloat16 prefilter replaced: every score, one
    ``torch.topk``."""
    n_real = c.shape[0] if n_real is None else n_real
    return torch.topk(q.bfloat16().float() @ c[:n_real].float().T, k, dim=1)


def _assert_same_topk(q, c, got, ref):
    """Scores within ``SCORE_TOL``; where the ids differ, both score the
    same in float64 (an exact tie)."""
    (v, i), (rv, ri) = got, ref
    torch.testing.assert_close(v, rv, **SCORE_TOL)
    exact = q.bfloat16().double() @ c.double().T
    differ = i != ri
    assert torch.equal(exact.gather(1, i)[differ], exact.gather(1, ri)[differ])


def _assert_close_to_float64(q, c, got, k, rel=REL):
    """Scores within ``rel`` of the float64 product's own score of each id
    and of the float64 top-k's; ids k distinct, and where they differ from
    the float64 top-k's, both scoring within twice the tolerance."""
    v, i = got
    exact = q.double() @ c.double().T
    tol = rel * (q.abs().double() @ c.abs().double().T)
    rv, ri = torch.topk(exact, k, dim=1)
    own = exact.gather(1, i)
    assert bool(((v.double() - own).abs() <= tol.gather(1, i)).all())
    assert bool(((v.double() - rv).abs() <= tol.gather(1, ri)).all())
    assert all(len(set(row)) == k for row in i.tolist())
    differ = i != ri
    assert bool(((own - exact.gather(1, ri)).abs()[differ]
                 <= 2 * tol.gather(1, ri)[differ]).all())


# Each precision's search through the prefilter, its sharded form, its span,
# the check of its top-k (against the full select, or the float64 product)
# and the words a launch of ``r`` query rows holds (``launch_rows``).
ROUTES = {
    "bfloat16": SimpleNamespace(
        p=prefilter.BF16, dtype=torch.bfloat16, search=topk.topk_mips_approx,
        sharded=topk.topk_mips_approx_sharded, span="search.prefilter",
        check=lambda q, c, got, k: _assert_same_topk(q, c, got, _full_select(q, c, k)),
        held=lambda r, n, k: (r * -(-n // BLOCK) + r * ((-(-n // BLOCK) + 1) // 2)
                              + -(-r // prefilter.QUERY_TILE) * -(-n // prefilter.CORPUS_TILE)
                              + r * k * BLOCK)),
    "float32": SimpleNamespace(
        p=prefilter.F32, dtype=torch.float32, search=topk.topk_mips_twopass,
        sharded=topk.topk_mips_sharded, span="search.twopass_prefilter",
        check=_assert_close_to_float64,
        held=lambda r, n, k: r * (-(-n // BLOCK) + k * (BLOCK + 8)) + 8 * (-(-n // BLOCK) + 1)),
}


@pytest.fixture(params=list(ROUTES))
def route(request, monkeypatch):
    """A precision's route, forced onto the plain versions on the CPU."""
    if request.param == "float32":
        _force(monkeypatch)
    return ROUTES[request.param]


def _launches(p):
    return p.maxima.launches, p.candidates.launches


# ---------------------------------------------------------------------------
# Both precisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100])
def test_padding_rows_past_num_valid_are_never_scored(k, route):
    """Rows past ``num_valid`` would win every query if scored."""
    q, c = _data(40, seed=7, dtype=route.dtype)
    valid = N - 2_011
    c[valid:] = (50.0 * q.abs().mean(0)).to(route.dtype)
    v, i = route.search(q, c, k, num_valid=valid)
    assert int(i.max()) < valid
    route.check(q, c[:valid], (v, i), k)


@pytest.mark.parametrize(
    "precision,dtype,d,n,k,num_valid,expected",
    [
        ("bfloat16", "bfloat16", 16, N, 100, None, True),
        ("bfloat16", "bfloat16", 256, 2_000, 1, None, True),
        ("bfloat16", "bfloat16", 16, 25_600, 100, None, False),  # 400 blocks: not more than 4 k
        ("bfloat16", "bfloat16", 16, N, 100, 25_600, False),  # the real rows decide
        ("bfloat16", "bfloat16", 24, N, 10, None, False),  # depth not a multiple of 16
        ("bfloat16", "bfloat16", 272, 2_000, 1, None, False),  # deeper than 256
        ("bfloat16", "float32", 16, N, 10, None, False),
        ("bfloat16", "int8", 16, N, 10, None, False),
        ("bfloat16", "int8_rowscale", 16, N, 10, None, False),
        ("float32", "float32", 16, N, 100, None, True),
        ("float32", "float32", 8, N, 10, None, True),
        ("float32", "float32", 256, 2_000, 1, None, True),
        ("float32", "float32", 40, N, 10, None, True),
        ("float32", "float32", 16, 25_600, 100, None, False),  # 400 blocks: not more than 4 k
        ("float32", "float32", 16, N, 100, 25_600, False),  # the real rows decide
        ("float32", "float32", 12, N, 10, None, False),  # depth not a multiple of 8
        ("float32", "float32", 264, 2_000, 1, None, False),  # deeper than 256
        ("float32", "bfloat16", 16, N, 10, None, False),  # the bfloat16 prefilter's, in approx
    ],
)
def test_the_path_is_chosen_by_dtype_depth_and_corpus_size(precision, dtype, d, n, k, num_valid,
                                                           expected, monkeypatch):
    """``topk_mips_approx`` (bfloat16) and ``topk_mips_twopass`` (float32,
    forced) search through the one ``topk_prefilter`` exactly where their
    precision ``applies``."""
    r = ROUTES[precision]
    if precision == "float32":
        _force(monkeypatch)
    q, c = _data(4, n=n, d=d, seed=d, dtype=torch.float32)
    scale = None
    if dtype.startswith("int8"):
        c, scale = topk.quantize_corpus(c.bfloat16().float(), per_row=dtype == "int8_rowscale")
    elif dtype == "float32" and precision == "bfloat16":
        c = c.bfloat16().float()  # the approx route's float32 case: the bf16 values
    else:
        c = c.to(getattr(torch, dtype))
    taken = []
    real = prefilter.topk_prefilter
    monkeypatch.setattr(prefilter, "topk_prefilter",
                        lambda *a: taken.append(a[1].shape) or real(*a))
    n_real = n if num_valid is None else num_valid
    assert r.p.applies(c, k, n_real) == expected
    kw = {} if scale is None else {"item_scale": scale}
    v, i = r.search(q, c, k, num_valid=num_valid, **kw)
    assert bool(taken) == expected and v.shape == i.shape == (4, k)
    assert int(i.max()) < n_real


@pytest.mark.parametrize("precision,budget_args,budget", [
    ("bfloat16", dict(item_chunk=2048, query_chunk=8), 2048 * 8),
    ("bfloat16", dict(item_chunk=512, query_chunk=4), 512 * 4),
    ("float32", dict(chunk_size=64), 37 * 64),  # batch x chunk_size: the scan's score buffer
    ("float32", dict(chunk_size=256), 37 * 256),
])
def test_small_budget_cuts_launches_and_chunks(precision, budget_args, budget, monkeypatch):
    """A small budget takes few query rows a launch: as many as keep what a
    launch holds within it (bfloat16: a row's maxima, candidates' ranks and
    candidates are 1,344 words at k 10 over 30,011 rows, and a query tile's
    flags 235 more; float32: a row's maxima, candidates and the select's
    words, and the work lists), one row where one is over it; and the plain
    versions' score chunks within it too, in chunks of a block multiple."""
    r = ROUTES[precision]
    if precision == "float32":
        _force(monkeypatch)
    q, c = _data(37, seed=11, dtype=r.dtype)
    launches = []
    real = prefilter.block_maxima_plain

    def spy(qq, corpus, n_real, chunk):
        launches.append((qq.shape[0], chunk))
        return real(qq, corpus, n_real, chunk)

    monkeypatch.setattr(prefilter, "block_maxima_plain", spy)
    v, i = r.search(q, c, 10, **budget_args)
    r.check(q, c, (v, i), 10)
    rows = r.p.launch_rows(37, N, 10, budget)
    held = r.held
    assert held(rows, N, 10) <= budget < held(rows + 1, N, 10) or (
        rows == 1 and budget < held(1, N, 10))
    assert len(launches) == -(-37 // rows) > 1
    assert all(n <= rows and n * ch <= budget and ch % BLOCK == 0 for n, ch in launches)


def test_the_prefilter_opens_its_span_once_a_call(route):
    """Two searches through the prefilter, one over a corpus too small for
    it (32 blocks: the scan) and one over the other dtype: two spans."""
    from torch.profiler import ProfilerActivity, profile

    q, c = _data(3, seed=9, dtype=route.dtype)
    other = c.float() if route.dtype == torch.bfloat16 else c.bfloat16()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            route.search(q, c, 10)
            route.search(q[:1], c, 5)
            route.search(q, c[:2_000], 10)
            route.search(q, other, 10)  # the present path
        names = [r.name for r in profiling.snapshot()["records"]]
    finally:
        profiling.reset()
    assert names.count(route.span) == 2


def test_sharded_search_takes_the_prefilter_per_shard(route, monkeypatch):
    """``topk_mips_approx_sharded`` and ``topk_mips_sharded`` (one process
    over a list of shards, here 2 of 30,011 rows, the second padded past
    ``num_items``) search each shard through the prefilter, on the shard's
    own rows, and merge the top-k."""
    q, c = _data(6, n=2 * N, seed=13, dtype=route.dtype)
    calls = []
    real = prefilter.topk_prefilter
    monkeypatch.setattr(prefilter, "topk_prefilter",
                        lambda *a: calls.append(a[3]) or real(*a))
    items = 2 * N - 5_000
    v, i = route.sharded(q, [c[:N], c[N:]], 10, num_items=items)
    assert calls == [N, N - 5_000]
    route.check(q, c[:items], (v, i), 10)


@pytest.mark.parametrize("precision,names,answers", [
    ("bfloat16", ["stream", "tt_prefilter_maxima", "tt_prefilter_scratch", "stream",
                  "tt_prefilter_candidates"], {}),
    ("float32", ["stream", "tt_prefilter_f32_maxima", "tt_prefilter_f32_query_tile", "stream",
                 "tt_prefilter_f32_candidates"], {"tt_prefilter_f32_query_tile": 128}),
])
def test_cuda_calls_run_with_the_inputs_card_current(precision, names, answers, monkeypatch):
    """The kernels' library reads the current device (the shared-memory
    opt-in, the SM count): its every call, and the stream it is given, come
    with ``torch.cuda.device(q.device)`` entered, so that a corpus shard on
    another card (``build_service(shard_corpus=True)``) launches there. On
    the CPU, with the library, the guard and the capture query faked; each
    launch counted once, by its own wrapper."""
    current, calls = [], []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            current.append(self.device)

        def __exit__(self, *exc):
            current.pop()

    class Lib:
        def __getattr__(self, name):
            def call(*args):
                calls.append((name, current[-1] if current else None))
                if name == "tt_prefilter_scratch":
                    args[3]._obj.value, args[4]._obj.value = 8, 2
                return answers.get(name, 0)
            return call

    def stream(t):
        calls.append(("stream", current[-1] if current else None))
        return 0

    p = ROUTES[precision].p
    monkeypatch.setattr(prefilter, "_lib", lambda source: Lib())
    monkeypatch.setattr(build, "on_cpu", lambda what, *tensors: False)
    monkeypatch.setattr(build, "stream", stream)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    q, c = _data(5, seed=4, dtype=p.dtype)
    q = q.to(p.dtype)
    before = [w.launches for w in prefilter.WRAPPERS]
    p.maxima(q, c, N)
    p.candidates(q, c, N, torch.zeros((5, 3), dtype=torch.int64))
    assert [name for name, _ in calls] == names
    assert all(device == q.device for _, device in calls)
    assert [w.launches - b for w, b in zip(prefilter.WRAPPERS, before)] == [
        int(w in (p.maxima, p.candidates)) for w in prefilter.WRAPPERS]


def test_cpu_tensors_never_reach_the_kernels(route, monkeypatch):
    monkeypatch.setattr(prefilter, "_lib",
                        lambda source: pytest.fail("the kernels' library loaded"))
    q, c = _data(2, seed=1, dtype=route.dtype)
    before = _launches(route.p)
    route.search(q, c, 10)
    assert _launches(route.p) == before


def test_search_launch_counts_share_the_loss_kernels_reset():
    assert prefilter.WRAPPERS == (prefilter.block_maxima, prefilter.block_candidates,
                                  prefilter.block_maxima_f32, prefilter.block_candidates_f32)
    everything = kernels.WRAPPERS + prefilter.WRAPPERS
    for w in everything:
        w.launches = 3
    record = build.LaunchRecord()
    record.counts[prefilter.block_maxima_f32] += 2
    record.replayed(2)
    assert [w.launches for w in everything] == [3] * 5 + [7, 3]
    build.reset_launch_counts()
    assert [w.launches for w in everything] == [0] * 7


# ---------------------------------------------------------------------------
# bfloat16
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("b", [1, 5, 256, 300])
def test_prefilter_returns_the_full_selects_top_k(b, k):
    q, c = _data(b, seed=b + k)
    assert prefilter.BF16.applies(c, k, N)
    v, i = topk.topk_mips_approx(q, c, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and v.shape == (b, k)
    _assert_same_topk(q, c, (v, i), _full_select(q, c, k))


@pytest.mark.parametrize("k", [10, 100])
def test_planted_equal_scores_compare_as_sets(k):
    """100 distinct rows, each repeated 300 times at random places: every
    block maximum and every top-k score ties many times over (far more than
    k blocks share the k-th largest maximum). The values equal the full
    select's, and the ids are k distinct rows scoring them."""
    rng = np.random.default_rng(5)
    q, distinct = _data(9, n=100, seed=3)
    c = distinct[torch.from_numpy(rng.permutation(np.arange(N) % 100))]
    v, i = topk.topk_mips_approx(q, c, k)
    rv, _ = _full_select(q, c, k)
    torch.testing.assert_close(v, rv, **SCORE_TOL)
    own = (q.bfloat16().float()[:, None, :] * c[i].float()).sum(-1)
    torch.testing.assert_close(own, v, **SCORE_TOL)
    assert all(len(set(row)) == k for row in i.tolist())


def test_block_maxima_plain_is_each_blocks_maximum():
    q, c = _data(6, seed=2)
    got = prefilter.block_maxima_plain(q.bfloat16(), c, N, chunk=1024)
    s = q.bfloat16().float() @ c.float().T
    s = F.pad(s, (0, -N % BLOCK), value=float("-inf"))
    assert torch.equal(got, s.view(6, -1, BLOCK).amax(dim=2))
    assert got.shape == (6, -(-N // BLOCK))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nblk,k", [(469, 1), (469, 10), (470, 29), (469, 100), (48, 3)])
def test_top_blocks_are_the_k_largest_maxima(nblk, k, ties):
    """The chosen blocks are k distinct blocks whose maxima are the k
    largest, in one select (at most k x SUPER blocks) or through the
    superblocks (a short last one at 469 blocks); with maxima drawn from 7
    values, ties cross superblocks and the k-th."""
    rng = np.random.default_rng(nblk + k)
    m = rng.integers(0, 7, (5, nblk)) if ties else rng.normal(size=(5, nblk))
    maxima = torch.from_numpy(m.astype(np.float32))
    chosen = prefilter.top_blocks(maxima, k)
    assert chosen.shape == (5, k) and all(len(set(row)) == k for row in chosen.tolist())
    got = maxima.gather(1, chosen).sort(dim=1, descending=True).values
    assert torch.equal(got, maxima.topk(k, dim=1).values)


@pytest.mark.parametrize("chunk", [1024, 4096, N + 5])
def test_block_candidates_plain_are_the_chosen_blocks_scores(chunk):
    """Each chosen block's scores in the list's order, whichever chunk of the
    corpus holds it; the ragged last block's columns past the corpus -inf."""
    q, c = _data(4, seed=6)
    chunk = chunk // BLOCK * BLOCK
    last = -(-N // BLOCK) - 1
    chosen = torch.tensor([[3, last, 0], [last, 17, 400], [250, 251, 5], [0, 1, 2]])
    got = prefilter.block_candidates_plain(q.bfloat16(), c, N, chosen, chunk)
    s = q.bfloat16().float() @ c.float().T
    s = F.pad(s, (0, -N % BLOCK), value=float("-inf"))
    want = s.view(4, -1, BLOCK)[torch.arange(4)[:, None], chosen].reshape(4, -1)
    assert torch.equal(got, want)
    assert bool(torch.isinf(got[1, N % BLOCK:BLOCK]).all())  # last, first


# ---------------------------------------------------------------------------
# float32
# ---------------------------------------------------------------------------


def test_a_bfloat16_corpus_keeps_the_approx_searchs_route(monkeypatch):
    """``topk_mips_approx`` over a bfloat16 corpus takes the prefilter, over
    a float32 one not (the float32 precision is the two-pass search's); the
    dispatch reads the corpus's dtype."""
    calls = []
    real = prefilter.topk_prefilter
    monkeypatch.setattr(prefilter, "topk_prefilter",
                        lambda *a: calls.append(a[1].dtype) or real(*a))
    q, c = _data(3, seed=2, dtype=torch.float32)
    topk.topk_mips_approx(q, c.bfloat16(), 10)
    topk.topk_mips_approx(q, c, 10)
    assert calls == [torch.bfloat16]


@pytest.mark.parametrize("d", [8, 16, 64, 256])
def test_plain_versions_against_a_float64_full_product(d):
    """Each block's maximum and the chosen blocks' scores within ``REL``
    of the float64 product's; the ragged last block's columns past the
    corpus -inf; the candidates' largest score of a block bit for bit its
    maximum."""
    q, c = _data(6, n=N, d=d, seed=d + 1, dtype=torch.float32)
    maxima = prefilter.block_maxima_plain(q, c, N, chunk=4096)
    assert maxima.shape == (6, -(-N // BLOCK))
    exact = F.pad(q.double() @ c.double().T, (0, -N % BLOCK), value=float("-inf"))
    tol = F.pad(REL * (q.abs().double() @ c.abs().double().T), (0, -N % BLOCK))
    exact, tol = exact.view(6, -1, BLOCK), tol.view(6, -1, BLOCK)
    assert bool(((maxima.double() - exact.amax(2)).abs() <= tol.amax(2)).all())
    last = maxima.shape[1] - 1
    chosen = torch.tensor([[3, last, 0], [last, 17, 400], [250, 251, 5], [0, 1, 2],
                           [7, 8, 9], [last, 0, 468]])
    cand = prefilter.block_candidates_plain(q, c, N, chosen, chunk=1024).view(6, 3, BLOCK)
    rows = torch.arange(6)[:, None]
    real = torch.isfinite(exact[rows, chosen])
    assert torch.equal(torch.isfinite(cand), real)
    assert bool(((cand.double() - exact[rows, chosen]).abs()[real]
                 <= tol[rows, chosen][real]).all())
    assert torch.equal(cand.amax(2), maxima.gather(1, chosen))


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("b", [0, 1, 5, 300])
def test_the_forced_route_returns_the_float64_top_k(b, k, forced):
    q, c = _data(b, seed=b + k, dtype=torch.float32)
    before = _launches(prefilter.F32)
    v, i = topk.topk_mips_twopass(q, c, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and v.shape == (b, k)
    _assert_close_to_float64(q, c, (v, i), k)
    assert _launches(prefilter.F32) == before  # no kernel on the CPU


@pytest.mark.parametrize("k", [10, 100])
def test_the_cover_argument_under_planted_ties(k, forced):
    """100 distinct rows, each repeated 300 times at random places: every
    block maximum and every top-k score ties many times over, at the k-th
    too (far more than k blocks share the k-th largest maximum). The
    values equal the float64 top-k's within the tolerance, each id scores
    its value, and the ids are k distinct rows."""
    rng = np.random.default_rng(5)
    q, distinct = _data(9, n=100, seed=3, dtype=torch.float32)
    c = distinct[torch.from_numpy(rng.permutation(np.arange(N) % 100))]
    v, i = topk.topk_mips_twopass(q, c, k)
    exact = q.double() @ c.double().T
    tol = REL * (q.abs().double() @ c.abs().double().T)
    rv, ri = torch.topk(exact, k, dim=1)
    assert bool(((v.double() - rv).abs() <= tol.gather(1, ri)).all())
    assert bool(((v.double() - exact.gather(1, i)).abs() <= tol.gather(1, i)).all())
    assert all(len(set(row)) == k for row in i.tolist())


@pytest.mark.parametrize("shape", [(1, 8), (7, 16), (300, 64)])
def test_cpu_results_of_topk_mips_twopass_are_todays(shape, monkeypatch):
    """On the CPU ``topk_mips_twopass`` is the chunked scan of the blocks it
    was: bit for bit ``_twopass_core``'s results, and neither the prefilter
    nor its plain versions called."""
    for name in ("topk_prefilter", "block_maxima_plain", "block_candidates_plain"):
        monkeypatch.setattr(prefilter, name,
                            lambda *a, _n=name: pytest.fail(f"{_n} called on the CPU"))
    b, d = shape
    q, c = _data(b, d=d, seed=b, dtype=torch.float32)
    v, i = topk.topk_mips_twopass(q, c, 10, chunk_size=4096)
    rv, ri = topk._twopass_core(q, c, 10, 4096, 64, N)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    with float32_products():
        full = torch.topk(q @ c.T, 10, dim=1)
    torch.testing.assert_close(v, full.values, rtol=1e-6, atol=1e-6)


def test_the_span_stays_shut_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    q, c = _data(3, seed=10, dtype=torch.float32)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            topk.topk_mips_twopass(q, c, 10)
        names = [r.name for r in profiling.snapshot()["records"]]
    finally:
        profiling.reset()
    assert "search.twopass_prefilter" not in names


def test_work_items_cover_each_blocks_pairs():
    """The candidates kernel's grid: every (row, rank) pair once, grouped by
    its block at most ``tile`` to an item, and the items past the last one
    marked with ``nblk``."""
    rng = np.random.default_rng(4)
    nblk, k, tile = 50, 7, 4
    chosen = torch.from_numpy(np.stack([rng.choice(nblk, k, replace=False) for _ in range(30)]))
    order, bounds, work_end, work_block = prefilter.work_items(chosen, nblk, tile)
    flat = chosen.reshape(-1)
    assert sorted(order.tolist()) == list(range(30 * k))
    assert torch.equal(flat[order], flat[order].sort().values)
    assert work_block.numel() == min(nblk, 30 * k) + -(-30 * k // tile)
    seen = []
    for w, b in enumerate(work_block.tolist()):
        if b == nblk:
            continue
        groups = -(-(int(bounds[b + 1]) - int(bounds[b])) // tile)
        lo = int(bounds[b]) + (w - (int(work_end[b]) - groups)) * tile
        items = order[lo:min(lo + tile, int(bounds[b + 1]))].tolist()
        assert 0 < len(items) <= tile and all(int(flat[e]) == b for e in items)
        seen += items
    assert sorted(seen) == list(range(30 * k))
    assert int(work_end[-1]) == sum(b < nblk for b in work_block.tolist())


# ---------------------------------------------------------------------------
# The kernels, on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the prefilter's kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_data(dev, b, n, d, seed, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, d, generator=gen, device=dev),
            torch.randn(n, d, generator=gen, device=dev).to(dtype))


def _check_bf16_kernels(q, real, n_real, k, maxima, chosen, cand):
    """Both kernels against their plain versions within float32 summation
    (rtol 1e-5 and atol 1e-5 x the largest |score|: the same exact bf16
    products summed in another order); returns the atol."""
    qb, chunk = q.bfloat16(), 1 << 16
    plain = prefilter.block_maxima_plain(qb, real, n_real, chunk)
    atol = 1e-5 * float(plain.abs().max())
    torch.testing.assert_close(maxima, plain, rtol=1e-5, atol=atol)
    torch.testing.assert_close(
        cand, prefilter.block_candidates_plain(qb, real, n_real, chosen, chunk),
        rtol=1e-5, atol=atol)
    return atol


def _check_bf16_search(q, real, n_real, k, v, i, atol):
    """The top-k against the full select's: scores within the kernels'
    tolerance, ids equal outside scores tied within it; the scratch the
    kernels ask for what ``launch_rows`` counts."""
    b, d = q.shape
    s = q.bfloat16().float() @ real.float().T
    rv, ri = torch.topk(s, k, dim=1)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=atol)
    differ = i != ri
    if differ.any():
        gap = (s.gather(1, i) - s.gather(1, ri)).abs()[differ].max()
        assert float(gap) <= atol
    lib = prefilter._lib(prefilter.BF16.source)
    assert lib.tt_prefilter_maxima(None, None, 1, 1, 24, None, None) != 0
    rank_len, flag_words = ctypes.c_longlong(), ctypes.c_longlong()
    assert lib.tt_prefilter_scratch(
        b, n_real, d, ctypes.byref(rank_len), ctypes.byref(flag_words)) == 0
    nblk = -(-n_real // BLOCK)
    assert rank_len.value == b * ((nblk + 1) // 2 * 2)
    assert flag_words.value == (-(-b // prefilter.QUERY_TILE)
                                * -(-n_real // prefilter.CORPUS_TILE))


def _check_f32_kernels(q, real, n_real, k, maxima, chosen, cand):
    """Both kernels against the float64 product (within ``KERNEL_REL`` of
    ``|q| . |c|``) and the maxima against their plain version."""
    b = q.shape[0]
    chunk = max(BLOCK, (1 << 26) // b // BLOCK * BLOCK)
    exact = F.pad(q.double() @ real.double().T, (0, -n_real % BLOCK), value=float("-inf"))
    mag = F.pad(q.abs().double() @ real.abs().double().T, (0, -n_real % BLOCK))
    exact, tol = exact.view(b, -1, BLOCK), KERNEL_REL * mag.view(b, -1, BLOCK)
    del mag
    assert bool(((maxima.double() - exact.amax(2)).abs() <= tol.amax(2)).all())
    plain = prefilter.block_maxima_plain(q, real, n_real, chunk)
    assert bool(((maxima - plain).abs().double()
                 <= (1 + REL / KERNEL_REL) * tol.amax(2)).all())
    rows = torch.arange(b, device=q.device)[:, None]
    cand = cand.view(b, k, BLOCK)
    finite = torch.isfinite(exact[rows, chosen])
    assert torch.equal(torch.isfinite(cand), finite)
    assert bool(((cand.double() - exact[rows, chosen]).abs()[finite]
                 <= tol[rows, chosen][finite]).all())


def _check_f32_search(q, real, n_real, k, v, i, atol):
    """The search's ids equal the float64 top-k's outside scores tied within
    the kernels' tolerance; the query tile the library reports."""
    _assert_close_to_float64(q.cpu(), real.cpu(), (v.cpu(), i.cpu()), k, rel=KERNEL_REL)
    lib = prefilter._lib(prefilter.F32.source)
    assert lib.tt_prefilter_f32_maxima(None, None, 1, 1, 12, None, None) != 0
    assert lib.tt_prefilter_f32_query_tile(q.shape[1]) == (128 if q.shape[1] <= 128 else 64)


_CUDA_CHECKS = {"bfloat16": (_check_bf16_kernels, _check_bf16_search),
                "float32": (_check_f32_kernels, _check_f32_search)}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "precision,b,n,d,k,num_valid",
    [("bfloat16", 4096, 200_003, 128, 100, None), ("bfloat16", 1, 300_000, 128, 100, 299_990),
     ("bfloat16", 300, 50_000, 64, 10, None), ("bfloat16", 257, 40_000, 16, 100, None),
     ("bfloat16", 5, 20_000, 256, 1, None), ("bfloat16", 33, 100_000, 96, 50, 99_999),
     ("float32", 4096, 200_003, 128, 100, None), ("float32", 1, 300_000, 128, 100, 299_990),
     ("float32", 300, 50_000, 64, 10, None), ("float32", 257, 40_000, 16, 100, None),
     ("float32", 5, 20_000, 256, 1, None), ("float32", 33, 100_000, 96, 50, 99_999),
     ("float32", 130, 30_011, 200, 10, None), ("float32", 64, 30_000, 160, 10, None)],
)
def test_cuda_kernels_match_plain(cuda_device, precision, b, n, d, k, num_valid):
    """Both kernels against their plain versions (and, in float32, the
    float64 product); each kept block's largest score equal to the maxima
    kernel's, bit for bit; the search's top-k against the full select's
    (bfloat16) or the float64 product's (float32), ids equal outside scores
    tied within the tolerance; one launch a call of each wrapper; a depth
    the kernels do not take refused at launch."""
    r = ROUTES[precision]
    check_kernels, check_search = _CUDA_CHECKS[precision]
    q, c = _cuda_data(cuda_device, b, n, d, b + n + d + k, r.dtype)
    n_real = n if num_valid is None else num_valid
    qk, real = q.to(r.dtype), c[:n_real]
    maxima = r.p.maxima(qk, real, n_real)
    chosen = prefilter.top_blocks(maxima, k)
    cand = r.p.candidates(qk, real, n_real, chosen)
    atol = check_kernels(q, real, n_real, k, maxima, chosen, cand)
    # Each kept block's largest score is, bit for bit, its maximum.
    assert torch.equal(cand.view(b, k, -1).amax(dim=2), maxima.gather(1, chosen))

    before = _launches(r.p)
    v, i = r.search(q, c, k, num_valid=num_valid)
    assert _launches(r.p) == (before[0] + 1, before[1] + 1)
    assert int(i.max()) < n_real
    check_search(q, real, n_real, k, v, i, atol)


@pytest.mark.cuda
def test_cuda_search_of_a_shard_on_another_card(cuda_device):
    """``build_service(shard_corpus=True)`` puts a corpus shard on every card
    of one process: a shard on the second card, searched while the first is
    current, launches there and gives the first card's bits; the two cards'
    shards merged give the one card's top-k (ids equal outside exact ties)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(300, 128, generator=gen)
    half = 100_096  # equal shards, each a multiple of the kernels' 128-row tile
    c = torch.randn(2 * half, 128, generator=gen).bfloat16()
    torch.cuda.set_device(0)
    one, two = torch.device("cuda:0"), torch.device("cuda:1")
    v0, i0 = topk.topk_mips_approx(q.to(one), c.to(one), 100)
    v1, i1 = topk.topk_mips_approx(q.to(two), c.to(two), 100)
    assert v1.device == two and torch.cuda.current_device() == 0
    assert torch.equal(v1.cpu(), v0.cpu()) and torch.equal(i1.cpu(), i0.cpu())
    vs, ids = topk.topk_mips_approx_sharded(q.to(one), [c[:half].to(one), c[half:].to(two)], 100)
    torch.testing.assert_close(vs.cpu(), v0.cpu(), rtol=0, atol=0)
    differ = ids.cpu() != i0.cpu()
    s = q.bfloat16().double() @ c.double().T
    assert torch.equal(s.gather(1, ids.cpu())[differ], s.gather(1, i0.cpu())[differ])


@pytest.mark.cuda
def test_cuda_scores_do_not_depend_on_the_launch(cuda_device):
    """A float32 row's maxima and candidates are bit for bit alike launched
    alone, in a batch of 4,096 and across split launches: no score depends
    on the rows beside it or on how the batch is cut."""
    q, c = _cuda_data(cuda_device, 4096, 300_007, 128, 21)
    n = c.shape[0]
    maxima = prefilter.block_maxima_f32(q, c, n)
    chosen = prefilter.top_blocks(maxima, 100)
    cand = prefilter.block_candidates_f32(q, c, n, chosen)
    for row in (0, 777, 4095):
        one = q[row:row + 1].contiguous()
        assert torch.equal(prefilter.block_maxima_f32(one, c, n), maxima[row:row + 1])
        assert torch.equal(prefilter.block_candidates_f32(
            one, c, n, chosen[row:row + 1].contiguous()), cand[row:row + 1])
    cut = (1000, 2500, 4096)
    parts = [(lo, hi) for lo, hi in zip((0,) + cut[:-1], cut)]
    assert torch.equal(torch.cat([prefilter.block_maxima_f32(q[lo:hi].contiguous(), c, n)
                                  for lo, hi in parts]), maxima)
    assert torch.equal(torch.cat([prefilter.block_candidates_f32(
        q[lo:hi].contiguous(), c, n, chosen[lo:hi].contiguous()) for lo, hi in parts]), cand)
    v, i = topk.topk_mips_twopass(q, c, 100)
    v1, i1 = topk.topk_mips_twopass(q[777:778], c, 100)
    assert torch.equal(v1, v[777:778])

"""The exact two-pass search's block-maxima prefilter over a float32 corpus
(``ops/prefilter_f32.py``): on the CPU the rule that picks the path, its
plain versions against a float64 full product, the cover argument under
planted ties with the path forced onto the plain versions, the span, the
budget, and ``topk_mips_twopass``'s CPU results unchanged (the chunked scan
of the blocks); on the card (``cuda`` tests) the kernels against their plain
versions and a float64 product, bit for bit against themselves.

Scores are three TF32 passes of split operands summed in float32: the plain
versions within ``REL`` times ``|q| . |c|`` (the sum of the products'
magnitudes) of the float64 product (the split leaves about 3 x 2^-22 of each
product out, the float32 sums add theirs; they read 2.1e-7 to 3.7e-7 of it
at depths 8 to 256 here), the kernels within ``KERNEL_REL`` (48 MMAs a score
at depth 128, each rounding toward zero by at most a float32 ulp of a
partial sum, and the split's 3 x 2^-22; they read about 1.1e-6 on the H100).
Ids equal the float64 top-k's except between scores within that tolerance.
This file imports no JAX, so that the card runs its ``cuda`` tests with
``--noconftest``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from twotower_tpu_torch.ops import kernels, prefilter, prefilter_f32, topk
from twotower_tpu_torch.utils import profiling

REL = 2e-6
KERNEL_REL = 48 * 2.0**-23 + 3 * 2.0**-22
BLOCK = prefilter_f32.BLOCK
N = 30_011  # ragged: 469 blocks of 64 and 59 rows over; more than 4 x 100 blocks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def forced(monkeypatch):
    """``topk_mips_twopass`` takes the float32 prefilter on the CPU too (the
    plain versions), wherever ``prefilter_f32.applies``."""
    monkeypatch.setattr(topk, "_on_the_float32_prefilter",
                        lambda emb, k, block, n_real: prefilter_f32.applies(emb, k, n_real))


def _data(b, n=N, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    return q, c


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


@pytest.mark.parametrize(
    "dtype,d,n,k,num_valid,expected",
    [
        ("float32", 16, N, 100, None, True),
        ("float32", 8, N, 10, None, True),
        ("float32", 256, 2_000, 1, None, True),
        ("float32", 40, N, 10, None, True),
        ("float32", 16, 25_600, 100, None, False),  # 400 blocks: not more than 4 k
        ("float32", 16, N, 100, 25_600, False),  # the real rows decide, not the padded
        ("float32", 12, N, 10, None, False),  # depth not a multiple of 8
        ("float32", 264, 2_000, 1, None, False),  # deeper than 256
        ("bfloat16", 16, N, 10, None, False),  # the bfloat16 prefilter's, in topk_mips_approx
    ],
)
def test_the_float32_route_is_chosen_by_dtype_depth_and_corpus_size(dtype, d, n, k, num_valid,
                                                                    expected, forced,
                                                                    monkeypatch):
    q, c = _data(4, n=n, d=d, seed=d)
    c = c.to(getattr(torch, dtype))
    taken = []
    real = prefilter_f32.topk_prefilter_f32
    monkeypatch.setattr(prefilter_f32, "topk_prefilter_f32",
                        lambda *a: taken.append(a[1].shape) or real(*a))
    n_real = n if num_valid is None else num_valid
    assert prefilter_f32.applies(c, k, n_real) == expected
    v, i = topk.topk_mips_twopass(q, c, k, num_valid=num_valid)
    assert bool(taken) == expected and v.shape == i.shape == (4, k)
    assert int(i.max()) < n_real


def test_a_bfloat16_corpus_keeps_the_approx_searchs_route(monkeypatch):
    """``topk_mips_approx`` over a bfloat16 corpus takes the bfloat16
    prefilter, over a float32 one neither; the dispatch reads the corpus's
    dtype."""
    calls = []
    for mod, name in ((prefilter, "topk_prefilter"), (prefilter_f32, "topk_prefilter_f32")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))
    q, c = _data(3, seed=2)
    topk.topk_mips_approx(q, c.bfloat16(), 10)
    topk.topk_mips_approx(q, c, 10)
    assert calls == ["topk_prefilter"]


@pytest.mark.parametrize("d", [8, 16, 64, 256])
def test_plain_versions_against_a_float64_full_product(d):
    """Each block's maximum and the chosen blocks' scores within ``REL``
    of the float64 product's; the ragged last block's columns past the
    corpus -inf; the candidates' largest score of a block bit for bit its
    maximum."""
    q, c = _data(6, n=N, d=d, seed=d + 1)
    maxima = prefilter_f32.block_maxima_plain(q, c, N, chunk=4096)
    assert maxima.shape == (6, -(-N // BLOCK))
    exact = F.pad(q.double() @ c.double().T, (0, -N % BLOCK), value=float("-inf"))
    tol = F.pad(REL * (q.abs().double() @ c.abs().double().T), (0, -N % BLOCK))
    exact, tol = exact.view(6, -1, BLOCK), tol.view(6, -1, BLOCK)
    assert bool(((maxima.double() - exact.amax(2)).abs() <= tol.amax(2)).all())
    last = maxima.shape[1] - 1
    chosen = torch.tensor([[3, last, 0], [last, 17, 400], [250, 251, 5], [0, 1, 2],
                           [7, 8, 9], [last, 0, 468]])
    cand = prefilter_f32.block_candidates_plain(q, c, N, chosen, chunk=1024).view(6, 3, BLOCK)
    rows = torch.arange(6)[:, None]
    real = torch.isfinite(exact[rows, chosen])
    assert torch.equal(torch.isfinite(cand), real)
    assert bool(((cand.double() - exact[rows, chosen]).abs()[real]
                 <= tol[rows, chosen][real]).all())
    assert torch.equal(cand.amax(2), maxima.gather(1, chosen))


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("b", [0, 1, 5, 300])
def test_the_forced_route_returns_the_float64_top_k(b, k, forced):
    q, c = _data(b, seed=b + k)
    before = (prefilter_f32.block_maxima_f32.launches,
              prefilter_f32.block_candidates_f32.launches)
    v, i = topk.topk_mips_twopass(q, c, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and v.shape == (b, k)
    _assert_close_to_float64(q, c, (v, i), k)
    assert (prefilter_f32.block_maxima_f32.launches,
            prefilter_f32.block_candidates_f32.launches) == before  # no kernel on the CPU


@pytest.mark.parametrize("k", [10, 100])
def test_the_cover_argument_under_planted_ties(k, forced):
    """100 distinct rows, each repeated 300 times at random places: every
    block maximum and every top-k score ties many times over, at the k-th
    too (far more than k blocks share the k-th largest maximum). The
    values equal the float64 top-k's within the tolerance, each id scores
    its value, and the ids are k distinct rows."""
    rng = np.random.default_rng(5)
    q, distinct = _data(9, n=100, seed=3)
    c = distinct[torch.from_numpy(rng.permutation(np.arange(N) % 100))]
    v, i = topk.topk_mips_twopass(q, c, k)
    exact = q.double() @ c.double().T
    tol = REL * (q.abs().double() @ c.abs().double().T)
    rv, ri = torch.topk(exact, k, dim=1)
    assert bool(((v.double() - rv).abs() <= tol.gather(1, ri)).all())
    assert bool(((v.double() - exact.gather(1, i)).abs() <= tol.gather(1, i)).all())
    assert all(len(set(row)) == k for row in i.tolist())


@pytest.mark.parametrize("k", [1, 10, 100])
def test_padding_rows_past_num_valid_are_never_scored(k, forced):
    """Rows past ``num_valid`` would win every query if scored."""
    q, c = _data(40, seed=7)
    valid = N - 2_011
    c[valid:] = 50.0 * q.abs().mean(0)
    v, i = topk.topk_mips_twopass(q, c, k, num_valid=valid)
    assert int(i.max()) < valid
    _assert_close_to_float64(q, c[:valid], (v, i), k)


@pytest.mark.parametrize("shape", [(1, 8), (7, 16), (300, 64)])
def test_cpu_results_of_topk_mips_twopass_are_todays(shape, monkeypatch):
    """On the CPU ``topk_mips_twopass`` is the chunked scan of the blocks it
    was: bit for bit ``_twopass_core``'s results, and no wrapper of the
    float32 prefilter called."""
    for name in ("topk_prefilter_f32", "block_maxima_f32", "block_candidates_f32"):
        monkeypatch.setattr(prefilter_f32, name,
                            lambda *a, _n=name: pytest.fail(f"{_n} called on the CPU"))
    b, d = shape
    q, c = _data(b, d=d, seed=b)
    v, i = topk.topk_mips_twopass(q, c, 10, chunk_size=4096)
    rv, ri = topk._twopass_core(q, c, 10, 4096, 64, N)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    with topk.float32_products():
        full = torch.topk(q @ c.T, 10, dim=1)
    torch.testing.assert_close(v, full.values, rtol=1e-6, atol=1e-6)


def test_the_search_opens_its_span_once_a_call_through_the_kernels(forced):
    from torch.profiler import ProfilerActivity, profile

    q, c = _data(3, seed=9)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            topk.topk_mips_twopass(q, c, 10)
            topk.topk_mips_twopass(q[:1], c, 5)
            topk.topk_mips_twopass(q, c[:2_000], 10)  # 32 blocks: the scan
            topk.topk_mips_twopass(q, c.bfloat16(), 10)  # bfloat16: the present path
        names = [r.name for r in profiling.snapshot()["records"]]
    finally:
        profiling.reset()
    assert names.count("search.twopass_prefilter") == 2


def test_the_span_stays_shut_on_the_cpu():
    from torch.profiler import ProfilerActivity, profile

    q, c = _data(3, seed=10)
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            topk.topk_mips_twopass(q, c, 10)
        names = [r.name for r in profiling.snapshot()["records"]]
    finally:
        profiling.reset()
    assert "search.twopass_prefilter" not in names


@pytest.mark.parametrize("chunk_size", [64, 256])
def test_small_budget_cuts_launches(chunk_size, forced, monkeypatch):
    """A budget of ``batch x chunk_size`` floats (the scan's score buffer)
    takes few query rows a launch: as many as keep a row's maxima,
    candidates and the select's and work lists' words within it."""
    q, c = _data(37, seed=11)
    launches = []
    real = prefilter_f32.block_maxima_f32

    def spy(qq, corpus, n_real):
        launches.append(qq.shape[0])
        return real(qq, corpus, n_real)

    monkeypatch.setattr(prefilter_f32, "block_maxima_f32", spy)
    v, i = topk.topk_mips_twopass(q, c, 10, chunk_size=chunk_size)
    _assert_close_to_float64(q, c, (v, i), 10)
    budget = 37 * chunk_size
    nblk = -(-N // BLOCK)

    def held(r):
        return r * (nblk + 10 * (BLOCK + 8)) + 8 * (nblk + 1)

    rows = prefilter_f32.launch_rows(37, N, 10, budget)
    assert rows == 1 or held(rows) <= budget < held(rows + 1)
    assert len(launches) == -(-37 // rows) > 1
    assert all(r <= rows for r in launches)


def test_work_items_cover_each_blocks_pairs():
    """The candidates kernel's grid: every (row, rank) pair once, grouped by
    its block at most ``tile`` to an item, and the items past the last one
    marked with ``nblk``."""
    rng = np.random.default_rng(4)
    nblk, k, tile = 50, 7, 4
    chosen = torch.from_numpy(np.stack([rng.choice(nblk, k, replace=False) for _ in range(30)]))
    order, bounds, work_end, work_block = prefilter_f32.work_items(chosen, nblk, tile)
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


def test_sharded_exact_search_takes_the_prefilter_per_shard(forced, monkeypatch):
    """``topk_mips_sharded`` (one process over a list of shards, here 2 of
    30,011 rows, the second padded past ``num_items``) searches each shard
    through the float32 prefilter, on the shard's own rows, and merges the
    float64 top-k."""
    q, c = _data(6, n=2 * N, seed=13)
    calls = []
    real = prefilter_f32.topk_prefilter_f32
    monkeypatch.setattr(prefilter_f32, "topk_prefilter_f32",
                        lambda *a: calls.append(a[3]) or real(*a))
    items = 2 * N - 5_000
    v, i = topk.topk_mips_sharded(q, [c[:N], c[N:]], 10, num_items=items)
    assert calls == [N, N - 5_000]
    _assert_close_to_float64(q, c[:items], (v, i), 10)


def test_cuda_calls_run_with_the_inputs_card_current(monkeypatch):
    """The kernels' library reads the current device (the shared-memory
    opt-in, the SM count): its every call, and the stream it is given, come
    with ``torch.cuda.device(q.device)`` entered, so that a corpus shard on
    another card launches there. On the CPU, with the library, the guard and
    the capture query faked; each launch counted once in ``ops.kernels``'
    counts."""
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
                return 128 if name == "tt_prefilter_f32_query_tile" else 0
            return call

    def stream(t):
        calls.append(("stream", current[-1] if current else None))
        return 0

    monkeypatch.setattr(prefilter_f32, "_lib", Lib)
    monkeypatch.setattr(prefilter, "_on_cpu", lambda q, c: False)
    monkeypatch.setattr(prefilter, "_stream", stream)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    q, c = _data(5, seed=4)
    before = [w.launches for w in kernels.SEARCH_WRAPPERS]
    prefilter_f32.block_maxima_f32(q, c, N)
    prefilter_f32.block_candidates_f32(q, c, N, torch.zeros((5, 3), dtype=torch.int64))
    assert [name for name, _ in calls] == ["stream", "tt_prefilter_f32_maxima",
                                           "tt_prefilter_f32_query_tile", "stream",
                                           "tt_prefilter_f32_candidates"]
    assert all(device == q.device for _, device in calls)
    assert [w.launches for w in kernels.SEARCH_WRAPPERS] == [
        before[0], before[1], before[2] + 1, before[3] + 1]


def test_cpu_tensors_never_reach_the_kernels(forced, monkeypatch):
    monkeypatch.setattr(prefilter_f32, "_lib", lambda: pytest.fail("the kernels' library loaded"))
    q, c = _data(2, seed=1)
    topk.topk_mips_twopass(q, c, 10)


# ---------------------------------------------------------------------------
# The kernels, on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the prefilter's kernels have no CPU mode)")
    return torch.device("cuda")


def _cuda_data(dev, b, n, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(b, d, generator=gen, device=dev),
            torch.randn(n, d, generator=gen, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,d,k,num_valid",
    [(4096, 200_003, 128, 100, None), (1, 300_000, 128, 100, 299_990), (300, 50_000, 64, 10, None),
     (257, 40_000, 16, 100, None), (5, 20_000, 256, 1, None), (33, 100_000, 96, 50, 99_999),
     (130, 30_011, 200, 10, None), (64, 30_000, 160, 10, None)],
)
def test_cuda_kernels_match_plain_and_float64(cuda_device, b, n, d, k, num_valid):
    """Both kernels against their plain versions and the float64 product
    (within ``KERNEL_REL`` of ``|q| . |c|``); each chosen block's largest
    candidate score equal to its block maximum, bit for bit; the search's
    ids equal the float64 top-k's outside scores tied within the
    tolerance; one launch of each wrapper a search; a depth the kernels do
    not take refused at launch."""
    q, c = _cuda_data(cuda_device, b, n, d, b + n + d + k)
    n_real = n if num_valid is None else num_valid
    real = c[:n_real]
    chunk = max(BLOCK, (1 << 26) // b // BLOCK * BLOCK)
    maxima = prefilter_f32.block_maxima_f32(q, real, n_real)
    exact = F.pad(q.double() @ real.double().T, (0, -n_real % BLOCK), value=float("-inf"))
    mag = F.pad(q.abs().double() @ real.abs().double().T, (0, -n_real % BLOCK))
    exact, tol = exact.view(b, -1, BLOCK), KERNEL_REL * mag.view(b, -1, BLOCK)
    del mag
    assert bool(((maxima.double() - exact.amax(2)).abs() <= tol.amax(2)).all())
    plain = prefilter_f32.block_maxima_plain(q, real, n_real, chunk)
    assert bool(((maxima - plain).abs().double()
                 <= (1 + REL / KERNEL_REL) * tol.amax(2)).all())
    chosen = prefilter.top_blocks(maxima, k)
    cand = prefilter_f32.block_candidates_f32(q, real, n_real, chosen).view(b, k, BLOCK)
    rows = torch.arange(b, device=cuda_device)[:, None]
    finite = torch.isfinite(exact[rows, chosen])
    assert torch.equal(torch.isfinite(cand), finite)
    assert bool(((cand.double() - exact[rows, chosen]).abs()[finite]
                 <= tol[rows, chosen][finite]).all())
    assert torch.equal(cand.amax(dim=2), maxima.gather(1, chosen))
    del exact, tol

    before = (prefilter_f32.block_maxima_f32.launches,
              prefilter_f32.block_candidates_f32.launches)
    v, i = topk.topk_mips_twopass(q, c, k, num_valid=num_valid)
    assert (prefilter_f32.block_maxima_f32.launches,
            prefilter_f32.block_candidates_f32.launches) == (before[0] + 1, before[1] + 1)
    assert int(i.max()) < n_real
    _assert_close_to_float64(q.cpu(), real.cpu(), (v.cpu(), i.cpu()), k, rel=KERNEL_REL)
    assert prefilter_f32._lib().tt_prefilter_f32_maxima(None, None, 1, 1, 12, None, None) != 0
    assert prefilter_f32._lib().tt_prefilter_f32_query_tile(d) == (128 if d <= 128 else 64)


@pytest.mark.cuda
def test_cuda_scores_do_not_depend_on_the_launch(cuda_device):
    """A row's maxima and candidates are bit for bit alike launched alone,
    in a batch of 4,096 and across split launches: no score depends on the
    rows beside it or on how the batch is cut."""
    q, c = _cuda_data(cuda_device, 4096, 300_007, 128, 21)
    n = c.shape[0]
    maxima = prefilter_f32.block_maxima_f32(q, c, n)
    chosen = prefilter.top_blocks(maxima, 100)
    cand = prefilter_f32.block_candidates_f32(q, c, n, chosen)
    for row in (0, 777, 4095):
        one = q[row:row + 1].contiguous()
        assert torch.equal(prefilter_f32.block_maxima_f32(one, c, n), maxima[row:row + 1])
        assert torch.equal(prefilter_f32.block_candidates_f32(
            one, c, n, chosen[row:row + 1].contiguous()), cand[row:row + 1])
    cut = (1000, 2500, 4096)
    parts = [(lo, hi) for lo, hi in zip((0,) + cut[:-1], cut)]
    assert torch.equal(torch.cat([prefilter_f32.block_maxima_f32(q[lo:hi].contiguous(), c, n)
                                  for lo, hi in parts]), maxima)
    assert torch.equal(torch.cat([prefilter_f32.block_candidates_f32(
        q[lo:hi].contiguous(), c, n, chosen[lo:hi].contiguous()) for lo, hi in parts]), cand)
    v, i = topk.topk_mips_twopass(q, c, 100)
    v1, i1 = topk.topk_mips_twopass(q[777:778], c, 100)
    assert torch.equal(v1, v[777:778])

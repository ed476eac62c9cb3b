"""The approx search's block-maxima prefilter over a bfloat16 corpus
(``ops/prefilter.py``): on the CPU its plain version against the full select
it replaced (``torch.topk`` over every float32 score of the bf16 queries
against the bf16 corpus), the rule that picks the path, and the span; on the
card (``cuda`` tests) the kernels against the plain version.

The full select here is one product of the upcast operands, the plain
version's the same product in other chunks: scores within rtol 1e-6
(float32 sums of the same exact products in another blocking), and ids
equal except between scores that tie exactly (bf16 rows of depth 16 tie now
and then even in float64). Planted equal scores are compared as sets.
This file imports no JAX, so that the card runs its ``cuda`` tests with
``--noconftest``.
"""

import ctypes

import numpy as np
import pytest
import torch

from twotower_tpu_torch.ops import prefilter, topk
from twotower_tpu_torch.utils import profiling

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)
N = 30_011  # ragged: 469 blocks of 64 and 59 rows over; more than 4 x 100 blocks


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(b, n=N, d=16, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).bfloat16()
    return q, c


def _full_select(q, c, k, n_real=None):
    """The select the prefilter replaced: every score, one ``torch.topk``."""
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


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("b", [1, 5, 256, 300])
def test_prefilter_returns_the_full_selects_top_k(b, k):
    q, c = _data(b, seed=b + k)
    assert prefilter.applies(c, k, N)
    v, i = topk.topk_mips_approx(q, c, k)
    assert v.dtype == torch.float32 and i.dtype == torch.int64 and v.shape == (b, k)
    _assert_same_topk(q, c, (v, i), _full_select(q, c, k))


@pytest.mark.parametrize("k", [1, 10, 100])
def test_padding_rows_past_num_valid_are_never_scored(k):
    """Rows past ``num_valid`` would win every query if scored."""
    q, c = _data(40, seed=7)
    valid = N - 2_011
    c[valid:] = (50.0 * q.abs().mean(0)).bfloat16()
    v, i = topk.topk_mips_approx(q, c, k, num_valid=valid)
    assert int(i.max()) < valid
    _assert_same_topk(q, c[:valid], (v, i), _full_select(q, c, k, valid))


@pytest.mark.parametrize("item_chunk,query_chunk", [(2048, 8), (512, 4)])
def test_small_budget_cuts_launches_and_chunks(item_chunk, query_chunk, monkeypatch):
    """A budget of ``query_chunk x item_chunk`` floats takes few query rows a
    launch (a row's maxima, candidates' ranks and candidates are 1,344 words
    at k 10 over 30,011 rows, and a query tile's flags 235 more): as many as
    keep all of them together within it, and the plain versions' score
    chunks too, in chunks of a block multiple."""
    q, c = _data(37, seed=11)
    launches = []
    real = prefilter.block_maxima_plain

    def spy(qq, corpus, n_real, chunk):
        launches.append((qq.shape[0], chunk))
        return real(qq, corpus, n_real, chunk)

    monkeypatch.setattr(prefilter, "block_maxima_plain", spy)
    v, i = topk.topk_mips_approx(q, c, 10, item_chunk=item_chunk, query_chunk=query_chunk)
    _assert_same_topk(q, c, (v, i), _full_select(q, c, 10))
    budget = item_chunk * query_chunk
    nblk = -(-N // prefilter.BLOCK)

    def held(r):  # maxima, int16 ranks, flags words, candidates: float32 words
        return (r * nblk + r * ((nblk + 1) // 2)
                + -(-r // prefilter.QUERY_TILE) * -(-N // prefilter.CORPUS_TILE)
                + r * 10 * prefilter.BLOCK)

    rows = prefilter.launch_rows(37, N, 10, budget)
    assert held(rows) <= budget < held(rows + 1)
    assert len(launches) == -(-37 // rows) > 1
    assert all(r <= rows and r * ch <= budget and ch % prefilter.BLOCK == 0
               for r, ch in launches)


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
    s = torch.nn.functional.pad(s, (0, -N % prefilter.BLOCK), value=float("-inf"))
    assert torch.equal(got, s.view(6, -1, prefilter.BLOCK).amax(dim=2))
    assert got.shape == (6, -(-N // prefilter.BLOCK))


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
    chunk = chunk // prefilter.BLOCK * prefilter.BLOCK
    last = -(-N // prefilter.BLOCK) - 1
    chosen = torch.tensor([[3, last, 0], [last, 17, 400], [250, 251, 5], [0, 1, 2]])
    got = prefilter.block_candidates_plain(q.bfloat16(), c, N, chosen, chunk)
    s = q.bfloat16().float() @ c.float().T
    s = torch.nn.functional.pad(s, (0, -N % prefilter.BLOCK), value=float("-inf"))
    want = s.view(4, -1, prefilter.BLOCK)[torch.arange(4)[:, None], chosen].reshape(4, -1)
    assert torch.equal(got, want)
    assert bool(torch.isinf(got[1, N % prefilter.BLOCK:prefilter.BLOCK]).all())  # last, first


@pytest.mark.parametrize(
    "dtype,d,n,k,num_valid,expected",
    [
        ("bfloat16", 16, N, 100, None, True),
        ("bfloat16", 256, 2_000, 1, None, True),
        ("bfloat16", 16, 25_600, 100, None, False),  # 400 blocks: not more than 4 k
        ("bfloat16", 16, N, 100, 25_600, False),  # the real rows decide, not the padded
        ("bfloat16", 24, N, 10, None, False),  # depth not a multiple of 16
        ("bfloat16", 272, 2_000, 1, None, False),  # deeper than 256
        ("float32", 16, N, 10, None, False),
        ("int8", 16, N, 10, None, False),
        ("int8_rowscale", 16, N, 10, None, False),
    ],
)
def test_the_path_is_chosen_by_dtype_depth_and_corpus_size(dtype, d, n, k, num_valid, expected,
                                                           monkeypatch):
    q, c = _data(4, n=n, d=d, seed=d)
    scale = None
    if dtype == "float32":
        c = c.float()
    elif dtype.startswith("int8"):
        c, scale = topk.quantize_corpus(c.float(), per_row=dtype == "int8_rowscale")
    taken = []
    real = prefilter.topk_prefilter
    monkeypatch.setattr(prefilter, "topk_prefilter",
                        lambda *a: taken.append(a[1].shape) or real(*a))
    n_real = n if num_valid is None else num_valid
    assert prefilter.applies(c, k, n_real) == expected
    v, i = topk.topk_mips_approx(q, c, k, num_valid=num_valid, item_scale=scale)
    assert bool(taken) == expected and v.shape == i.shape == (4, k)
    assert int(i.max()) < n_real


def test_the_prefilter_opens_its_span_once_a_call():
    from torch.profiler import ProfilerActivity, profile

    q, c = _data(3, seed=9)
    cf = c.float()
    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            topk.topk_mips_approx(q, c, 10)
            topk.topk_mips_approx(q[:1], c, 5)
            topk.topk_mips_approx(q, cf, 10)  # float32: the present path
        names = [r.name for r in profiling.snapshot()["records"]]
    finally:
        profiling.reset()
    assert names.count("search.prefilter") == 2


def test_sharded_approx_search_takes_the_prefilter_per_shard(monkeypatch):
    """``topk_mips_approx_sharded`` searches each shard (here 2 of 30,011
    rows, the second padded past ``num_items``) through the prefilter."""
    q, c = _data(6, n=2 * N, seed=13)
    calls = []
    real = prefilter.topk_prefilter
    monkeypatch.setattr(prefilter, "topk_prefilter",
                        lambda *a: calls.append(a[3]) or real(*a))
    v, i = topk.topk_mips_approx_sharded(q, [c[:N], c[N:]], 10, num_items=2 * N - 5_000)
    assert calls == [N, N - 5_000]
    _assert_same_topk(q, c[:2 * N - 5_000], (v, i), _full_select(q, c, 10, 2 * N - 5_000))


def test_cuda_calls_run_with_the_inputs_card_current(monkeypatch):
    """The kernels' library reads the current device (the shared-memory
    opt-in, the SM count): its every call, and the stream it is given, come
    with ``torch.cuda.device(q.device)`` entered, so that a corpus shard on
    another card (``build_service(shard_corpus=True)``) launches there. On
    the CPU, with the library, the guard and the capture query faked; each
    launch counted once in ``ops.kernels``' counts."""
    from twotower_tpu_torch.ops import kernels

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
                return 0
            return call

    def stream(t):
        calls.append(("stream", current[-1] if current else None))
        return 0

    monkeypatch.setattr(prefilter, "_lib", Lib)
    monkeypatch.setattr(prefilter, "_on_cpu", lambda q, c: False)
    monkeypatch.setattr(prefilter, "_stream", stream)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    q, c = _data(5, seed=4)
    q = q.bfloat16()
    before = [w.launches for w in kernels.SEARCH_WRAPPERS]
    prefilter.block_maxima(q, c, N)
    prefilter.block_candidates(q, c, N, torch.zeros((5, 3), dtype=torch.int64))
    assert [name for name, _ in calls] == ["stream", "tt_prefilter_maxima",
                                           "tt_prefilter_scratch", "stream",
                                           "tt_prefilter_candidates"]
    assert all(device == q.device for _, device in calls)
    assert [w.launches for w in kernels.SEARCH_WRAPPERS] == [n + 1 for n in before]


def test_search_launch_counts_share_the_loss_kernels_reset():
    from twotower_tpu_torch.ops import kernels

    assert kernels.SEARCH_WRAPPERS == (prefilter.block_maxima, prefilter.block_candidates)
    for w in kernels.WRAPPERS + kernels.SEARCH_WRAPPERS:
        w.launches = 3
    assert set(kernels.LaunchRecord().counts) == set(kernels.WRAPPERS + kernels.SEARCH_WRAPPERS)
    kernels.reset_launch_counts()
    assert [w.launches for w in kernels.WRAPPERS + kernels.SEARCH_WRAPPERS] == [0] * 5


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    monkeypatch.setattr(prefilter, "_lib", lambda: pytest.fail("the kernels' library loaded"))
    q, c = _data(2, seed=1)
    before = (prefilter.block_maxima.launches, prefilter.block_candidates.launches)
    topk.topk_mips_approx(q, c, 10)
    assert (prefilter.block_maxima.launches, prefilter.block_candidates.launches) == before


# ---------------------------------------------------------------------------
# The kernels, on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the prefilter's kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,n,d,k,num_valid",
    [(4096, 200_003, 128, 100, None), (1, 300_000, 128, 100, 299_990), (300, 50_000, 64, 10, None),
     (257, 40_000, 16, 100, None), (5, 20_000, 256, 1, None), (33, 100_000, 96, 50, 99_999)],
)
def test_cuda_kernels_match_plain(cuda_device, b, n, d, k, num_valid):
    """Both kernels against their plain versions within float32 summation
    (rtol 1e-5 and atol 1e-5 x the largest |score|: the same exact bf16
    products summed in another order); each kept block's largest score
    equal to the maxima kernel's, bit for bit; the top-k against the full
    select's: scores the same tolerance, ids equal outside scores tied
    within it; one launch a call of each wrapper; a depth the kernels do not
    take refused at launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(b + n + d + k)
    q = torch.randn(b, d, generator=gen, device=cuda_device)
    c = torch.randn(n, d, generator=gen, device=cuda_device).bfloat16()
    n_real = n if num_valid is None else num_valid
    qb, real = q.bfloat16(), c[:n_real]
    chunk = 1 << 16
    maxima = prefilter.block_maxima(qb, real, n_real)
    plain = prefilter.block_maxima_plain(qb, real, n_real, chunk)
    atol = 1e-5 * float(plain.abs().max())
    torch.testing.assert_close(maxima, plain, rtol=1e-5, atol=atol)
    chosen = prefilter.top_blocks(maxima, k)
    cand = prefilter.block_candidates(qb, real, n_real, chosen)
    torch.testing.assert_close(
        cand, prefilter.block_candidates_plain(qb, real, n_real, chosen, chunk),
        rtol=1e-5, atol=atol)
    # Each kept block's largest score is, bit for bit, its maximum.
    assert torch.equal(cand.view(b, k, -1).amax(dim=2), maxima.gather(1, chosen))

    before = (prefilter.block_maxima.launches, prefilter.block_candidates.launches)
    v, i = topk.topk_mips_approx(q, c, k, num_valid=num_valid)
    after = (prefilter.block_maxima.launches, prefilter.block_candidates.launches)
    assert after == (before[0] + 1, before[1] + 1)
    s = qb.float() @ real.float().T
    rv, ri = torch.topk(s, k, dim=1)
    torch.testing.assert_close(v, rv, rtol=1e-5, atol=atol)
    differ = i != ri
    if differ.any():
        gap = (s.gather(1, i) - s.gather(1, ri)).abs()[differ].max()
        assert float(gap) <= atol
    assert int(i.max()) < n_real
    assert prefilter._lib().tt_prefilter_maxima(None, None, 1, 1, 24, None, None) != 0
    # The scratch the kernels ask for is what launch_rows counts.
    rank_len, flag_words = ctypes.c_longlong(), ctypes.c_longlong()
    assert prefilter._lib().tt_prefilter_scratch(
        b, n_real, d, ctypes.byref(rank_len), ctypes.byref(flag_words)) == 0
    nblk = -(-n_real // prefilter.BLOCK)
    assert rank_len.value == b * ((nblk + 1) // 2 * 2)
    assert flag_words.value == (-(-b // prefilter.QUERY_TILE)
                                * -(-n_real // prefilter.CORPUS_TILE))


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

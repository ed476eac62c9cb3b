"""Exact top-k over a float32 corpus through a block-maxima prefilter at
float32 accuracy: ``topk_mips_twopass``'s path on the card for a float32
corpus of depth a multiple of 8 up to 256 and more than ``4 k`` blocks of
``BLOCK`` rows (``applies``). The bfloat16 corpus of ``topk_mips_approx``
has its own path, ``ops/prefilter.py``; the two share the block select
``prefilter.top_blocks`` and the exactness argument below.

Three steps a launch of query rows:

1. ``block_maxima_f32``: each row's maximum score over each block of
   ``BLOCK`` consecutive corpus rows, ``[rows, ceil(n / BLOCK)]`` float32.
2. ``prefilter.top_blocks``: the row's k blocks of largest maximum.
3. ``block_candidates_f32``: the row's scores of those k blocks, ``[rows, k
   * BLOCK]``, and the exact top-k of them.

Why it is exact: the top-k scores of a row lie in at most k blocks, and a
block holding one has a maximum at least the k-th score, so the k blocks of
largest maximum hold every top-k score; where blocks tie at the k-th maximum
any choice among them does. Steps 1 and 3 must compute every score bit for
bit alike, and each score must depend on its query row and corpus row alone.
The kernels (``ops/csrc/search_prefilter_f32.cu``) run one instruction
sequence for both, the candidates only over the chosen blocks; the plain
versions multiply the same chunks in the same shapes.

Scores are three TF32 passes of operands split into ``hi = rna(x)`` and
``lo = rna(x - hi)`` (``kernels.tf32_split_plain``), ``lo.hi + hi.lo +
hi.hi`` accumulated in float32: float32 accuracy, as the fused loss's
kernels and the benchmark's float32 peak count it. On the card the kernels'
tensor-core products; the plain versions the three float32 products of the
split operands (TF32 off). Each wrapper takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel, with the
tensors' card as the current device, or raises. Each counts its launches in
``<wrapper>.launches``, through ``ops.kernels``' launch counts
(``kernels.SEARCH_WRAPPERS``).
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch
import torch.nn.functional as F

from twotower_tpu_torch.ops import prefilter

BLOCK = prefilter.BLOCK  # corpus rows a block maximum covers (the kernels' MMA tile)
MAX_DEPTH = 256


def applies(item_emb: torch.Tensor, k: int, n_real: int) -> bool:
    """Whether ``item_emb``'s first ``n_real`` rows are searched through the
    float32 prefilter: a float32 corpus, depth a multiple of 8 up to
    ``MAX_DEPTH``, and more than ``4 k`` blocks (``topk_mips_twopass``'s
    rule)."""
    dim = item_emb.shape[1]
    return (item_emb.dtype == torch.float32 and dim % 8 == 0 and 0 < dim <= MAX_DEPTH
            and n_real > 4 * k * BLOCK)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _score_blocks(q: torch.Tensor, corpus: torch.Tensor, n_real: int, chunk: int):
    """``(first block, [rows, blocks, BLOCK] float32 scores)`` of the corpus
    rows below ``n_real``, ``chunk`` (a ``BLOCK`` multiple) rows at a time,
    three products of the split operands; the last block's columns past
    ``n_real`` are ``-inf``."""
    # Imported here: ops.kernels imports this module.
    from twotower_tpu_torch.ops.kernels import tf32_split_plain
    from twotower_tpu_torch.ops.topk import float32_products

    q_hi, q_lo = tf32_split_plain(q)
    for lo in range(0, n_real, chunk):
        c_hi, c_lo = tf32_split_plain(corpus[lo:min(lo + chunk, n_real)])
        with float32_products():
            s = q_lo @ c_hi.T + q_hi @ c_lo.T + q_hi @ c_hi.T
        s = F.pad(s, (0, -s.shape[1] % BLOCK), value=float("-inf"))
        yield lo // BLOCK, s.view(s.shape[0], -1, BLOCK)


def block_maxima_plain(q, corpus, n_real: int, chunk: int) -> torch.Tensor:
    """Plain version of ``block_maxima_f32``: ``[rows, ceil(n_real / BLOCK)]``."""
    return torch.cat([s.amax(dim=2) for _, s in _score_blocks(q, corpus, n_real, chunk)], dim=1)


def block_candidates_plain(q, corpus, n_real: int, chosen: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """Plain version of ``block_candidates_f32``: ``[rows, k * BLOCK]``."""
    rows, k = chosen.shape
    out = torch.full((rows, k, BLOCK), float("-inf"), device=q.device)
    for first, s in _score_blocks(q, corpus, n_real, chunk):
        local = chosen - first
        here = (local >= 0) & (local < s.shape[1])
        got = torch.gather(s, 1, local.clamp(0, s.shape[1] - 1)[:, :, None].expand(-1, -1, BLOCK))
        out = torch.where(here[:, :, None], got, out)
    return out.view(rows, k * BLOCK)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@cache
def _lib() -> ctypes.CDLL:
    # Imported here: importing the ops package loads no kernel machinery.
    from twotower_tpu_torch.ops import build

    lib = build.load("search_prefilter_f32.cu")
    lib.tt_prefilter_f32_query_tile.argtypes = [_I]
    lib.tt_prefilter_f32_query_tile.restype = ctypes.c_int
    lib.tt_prefilter_f32_maxima.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    lib.tt_prefilter_f32_maxima.restype = ctypes.c_int
    lib.tt_prefilter_f32_candidates.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P,
                                                _P]
    lib.tt_prefilter_f32_candidates.restype = ctypes.c_int
    return lib


def _check_cuda(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> None:
    dim = corpus.shape[1]
    if not (q.dtype == corpus.dtype == torch.float32 and q.is_contiguous()
            and corpus.is_contiguous() and q.dim() == corpus.dim() == 2 and q.shape[1] == dim):
        raise ValueError(
            f"float32 prefilter kernel: queries and corpus must be contiguous float32 [rows, D] "
            f"and [N, D], got {q.dtype} {tuple(q.shape)} and {corpus.dtype} {tuple(corpus.shape)}")
    if not (dim % 8 == 0 and 0 < dim <= MAX_DEPTH and 0 < n_real <= corpus.shape[0] < 2**31
            and 0 < q.shape[0] < 2**31 and q.data_ptr() % 16 == 0 and corpus.data_ptr() % 16 == 0):
        raise ValueError(f"float32 prefilter kernel does not cover rows={q.shape[0]}, D={dim}, "
                         f"n={n_real} of {corpus.shape[0]} (or an address not 16-byte aligned)")


def block_maxima_f32(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> torch.Tensor:
    """``[rows, ceil(n_real / BLOCK)]`` float32: each float32 query row's
    maximum score over each ``BLOCK`` rows of the corpus's first ``n_real``.
    The kernel on CUDA tensors (the scores never reach device memory); the
    plain version on CPU tensors."""
    if prefilter._on_cpu(q, corpus):
        return block_maxima_plain(q, corpus, n_real, prefilter._plain_chunk(n_real))
    _check_cuda(q, corpus, n_real)
    rows = q.shape[0]
    out = torch.empty((rows, -(-n_real // BLOCK)), dtype=torch.float32, device=q.device)
    # The library reads the current device for the kernels' shared-memory
    # opt-in and the SM count: a corpus shard on another card must be it.
    with torch.cuda.device(q.device):
        rc = _lib().tt_prefilter_f32_maxima(q.data_ptr(), corpus.data_ptr(), rows, n_real,
                                            corpus.shape[1], out.data_ptr(), prefilter._stream(q))
    prefilter._raise_on(rc, "prefilter_f32_maxima_kernel")
    prefilter._count(block_maxima_f32)
    return out


def work_items(chosen: torch.Tensor, nblk: int, tile: int):
    """The candidates kernel's grid, from the rows' chosen blocks ``[rows,
    k]``: ``(order, bounds, work_end, work_block)``, the pairs ``r k + i``
    sorted by block, each block's first pair ``[nblk + 1]``, the work items
    (``tile`` pairs of one block at a time) through each block ``[nblk]``,
    and each item's block (``nblk`` past the last item) for as many items as
    there can be: ``min(nblk, pairs) + ceil(pairs / tile)``. All on the
    card, with no read back to the host."""
    flat = chosen.reshape(-1)
    blocks, order = torch.sort(flat)
    dev = chosen.device
    bounds = torch.searchsorted(blocks, torch.arange(nblk + 1, device=dev))
    work_end = torch.cumsum((bounds[1:] - bounds[:-1] + tile - 1) // tile, 0)
    items = min(nblk, flat.numel()) + -(-flat.numel() // tile)
    work_block = torch.searchsorted(work_end, torch.arange(items, device=dev), right=True)
    return order, bounds, work_end, work_block


def block_candidates_f32(q: torch.Tensor, corpus: torch.Tensor, n_real: int,
                         chosen: torch.Tensor) -> torch.Tensor:
    """``[rows, k * BLOCK]`` float32: for each float32 query row, its scores
    of each of the k blocks ``chosen[row]`` (distinct block indices, int64
    ``[rows, k]``), in that order; columns past ``n_real`` are ``-inf``. The
    kernel on CUDA tensors (the chosen blocks alone, ``work_items``); the
    plain version on CPU tensors."""
    if prefilter._on_cpu(q, corpus):
        return block_candidates_plain(q, corpus, n_real, chosen, prefilter._plain_chunk(n_real))
    _check_cuda(q, corpus, n_real)
    rows, k = chosen.shape
    if (chosen.dtype != torch.int64 or rows != q.shape[0] or chosen.device != q.device
            or not 0 < k < 2**31 // BLOCK):
        raise ValueError(f"float32 prefilter kernel: chosen must be int64 [{q.shape[0]}, k] on "
                         f"{q.device}")
    lib = _lib()
    dim = corpus.shape[1]
    with torch.cuda.device(q.device):  # as block_maxima_f32's
        order, bounds, work_end, work_block = work_items(
            chosen, -(-n_real // BLOCK), lib.tt_prefilter_f32_query_tile(dim))
        out = torch.full((rows, k * BLOCK), float("-inf"), device=q.device)
        rc = lib.tt_prefilter_f32_candidates(
            q.data_ptr(), corpus.data_ptr(), rows, n_real, dim, k, order.data_ptr(),
            bounds.data_ptr(), work_end.data_ptr(), work_block.data_ptr(), work_block.numel(),
            out.data_ptr(), prefilter._stream(q))
    prefilter._raise_on(rc, "prefilter_f32_candidates_kernel")
    prefilter._count(block_candidates_f32)
    return out


block_maxima_f32.launches = 0
block_candidates_f32.launches = 0


def launch_rows(b: int, n_real: int, k: int, budget: int) -> int:
    """Query rows a launch takes, of ``b``: as many as keep what the launch
    holds on the card within ``budget`` float32 words, counting a row's
    maxima and candidates, eight words a pair for its chosen blocks, their
    sorted copy, their order and the work items, and eight words a block
    for the work lists; at least one."""
    nblk = -(-n_real // BLOCK)
    per_row = nblk + k * (BLOCK + 8)
    return max(1, min(b, (budget - 8 * (nblk + 1)) // per_row))


def topk_prefilter_f32(query: torch.Tensor, corpus: torch.Tensor, k: int, n_real: int,
                       budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the float32-accurate scores of ``query`` against
    the corpus's first ``n_real`` rows: ``(scores [B, k] float32
    descending, ids [B, k] int64)``. A launch takes ``launch_rows`` query
    rows, which keeps what it holds within ``budget`` float32 words."""
    b = query.shape[0]
    if b == 0:
        return (torch.zeros((0, k), device=corpus.device),
                torch.zeros((0, k), dtype=torch.long, device=corpus.device))
    rows = launch_rows(b, n_real, k, budget)
    query = query.float()
    out_vals, out_ids = [], []
    for start in range(0, b, rows):
        q = query[start:start + rows].contiguous()
        maxima = block_maxima_f32(q, corpus, n_real)
        chosen = prefilter.top_blocks(maxima, k)
        del maxima
        scores = block_candidates_f32(q, corpus, n_real, chosen)
        top, pos = torch.topk(scores, k, dim=1)
        out_vals.append(top)
        out_ids.append(torch.gather(chosen, 1, pos // BLOCK) * BLOCK + pos % BLOCK)
    return torch.cat(out_vals), torch.cat(out_ids)

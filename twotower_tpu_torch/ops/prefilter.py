"""Exact top-k through a block-maxima prefilter, in two precisions: the path
of ``topk_mips_approx`` over a bfloat16 corpus (``BF16``) and, on the card,
of ``topk_mips_twopass`` over a float32 one (``F32``). Each takes a corpus of
its dtype, of depth a multiple of 16 (bfloat16) or 8 (float32) up to
``MAX_DEPTH``, and more than ``4 k`` blocks of ``BLOCK`` rows
(``Precision.applies``).

Three steps a launch of query rows (``topk_prefilter``):

1. block maxima: each row's maximum score over each block of ``BLOCK``
   consecutive corpus rows, ``[rows, ceil(n / BLOCK)]`` float32.
2. ``top_blocks``: the row's k blocks of largest maximum (``torch.topk``,
   the counterpart of the JAX package's ``lax.top_k``, over the maxima of
   superblocks of ``SUPER`` blocks, then over the blocks of the k chosen).
3. block candidates: the row's scores of those k blocks, ``[rows, k *
   BLOCK]``, and the exact top-k of them.

Why it is exact (``topk_mips_twopass``'s argument): the top-k scores of a
row lie in at most k blocks, and a block holding one has a maximum at
least the k-th score, so the k blocks of largest maximum hold every top-k
score. Where blocks tie at the k-th maximum any choice among them does: a
top-k score of a block left out equals a score kept in its place. Steps 1
and 3 must compute every score bit for bit alike. The bfloat16 kernels
launch the same tiles in the same grid (``ops/csrc/search_prefilter.cu``);
the float32 candidates kernel runs the maxima kernel's very MMAs over the
chosen blocks alone, so that a score also depends on its query row and
corpus row alone (``ops/csrc/search_prefilter_f32.cu``). The plain versions
multiply the same chunks in the same shapes.

The scores, and so the plain versions' product (``Precision.product``), are
the precision's:

- bfloat16: the queries in bfloat16 against the corpus, accumulated in
  float32, as ``ops.topk._scores``: on the card the kernels' tensor-core
  products, on the CPU both operands upcast to float32 (a product of two
  bf16 values is exact there).
- float32: three TF32 passes of operands split into ``hi`` and ``lo``
  (``precision.tf32_split_plain``), ``lo.hi + hi.lo + hi.hi`` accumulated
  in float32: float32 accuracy, as the fused loss's kernels and the
  benchmark's float32 peak count it. On the card the kernels' tensor-core
  products, in the plain versions the three float32 products of the split
  operands (TF32 off).

Each wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernels, with the tensors' card as the current
device, or raises. Each counts its launches in ``<wrapper>.launches``
(``build.counted``); ``WRAPPERS`` lists the four.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from dataclasses import dataclass
from functools import cache

import torch
import torch.nn.functional as F

from twotower_tpu_torch.ops import build
from twotower_tpu_torch.ops.precision import float32_products, tf32_split_plain

BLOCK = 64  # corpus rows a block maximum covers (the kernels' block)
SUPER = 16  # blocks a superblock of the select covers
MAX_DEPTH = 256
QUERY_TILE = 256  # query rows a bfloat16 kernel block holds (kBM), and so a flags word's rows
CORPUS_TILE = 128  # corpus rows a bfloat16 kernel tile covers (kBN): two blocks


def top_blocks(maxima: torch.Tensor, k: int) -> torch.Tensor:
    """``[rows, k]`` int64: each row's k blocks of largest maximum (any of
    those tied at the k-th). The k superblocks (``SUPER`` blocks each, the
    last one short) of largest maximum hold them, by the module's argument
    one level up (a block left out with a tied superblock is tied at the
    k-th, or below k kept blocks' maxima), so the select runs over the
    superblocks' maxima, then over the k x ``SUPER`` blocks of those chosen:
    two small selects in place of one over every block."""
    rows, nblk = maxima.shape
    if nblk <= k * SUPER:
        return torch.topk(maxima, k, dim=1, sorted=False).indices
    sup = F.max_pool1d(maxima[:, None], SUPER, ceil_mode=True)[:, 0]
    picked = torch.topk(sup, k, dim=1, sorted=False).indices
    blocks = (picked[:, :, None] * SUPER
              + torch.arange(SUPER, device=maxima.device)).flatten(1)
    real = blocks < nblk  # the last superblock may be short; each chosen one holds a block
    inner = torch.gather(maxima, 1, blocks.clamp(max=nblk - 1)).masked_fill(~real, float("-inf"))
    return torch.gather(blocks, 1, torch.topk(inner, k, dim=1, sorted=False).indices)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _bf16_product(q: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """The bfloat16 scores of ``q`` against a chunk of corpus rows: the
    queries rounded to bfloat16, both operands upcast to float32."""
    qf = q.to(torch.bfloat16).float()
    return lambda chunk: qf @ chunk.float().T


def _f32_product(q: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """The float32-accurate scores of ``q`` against a chunk of corpus rows:
    three float32 products of the split operands, TF32 off."""
    q_hi, q_lo = tf32_split_plain(q)

    def product(chunk: torch.Tensor) -> torch.Tensor:
        c_hi, c_lo = tf32_split_plain(chunk)
        with float32_products():
            return q_lo @ c_hi.T + q_hi @ c_lo.T + q_hi @ c_hi.T

    return product


def _score_blocks(q: torch.Tensor, corpus: torch.Tensor, n_real: int, chunk: int):
    """``(first block, [rows, blocks, BLOCK] float32 scores)`` of the corpus
    rows below ``n_real``, ``chunk`` (a ``BLOCK`` multiple) rows at a time,
    in the corpus's precision; the last block's columns past ``n_real`` are
    ``-inf``."""
    product = _PRECISIONS[corpus.dtype].product(q)
    for lo in range(0, n_real, chunk):
        s = product(corpus[lo:min(lo + chunk, n_real)])
        s = F.pad(s, (0, -s.shape[1] % BLOCK), value=float("-inf"))
        yield lo // BLOCK, s.view(s.shape[0], -1, BLOCK)


def _plain_chunk(n_real: int) -> int:
    """The plain versions' corpus rows a chunk: as many as there are blocks
    (a ``BLOCK`` multiple, at least one block), so that a chunk's scores
    take no more room than the maxima or the candidates."""
    return max(BLOCK, -(-n_real // BLOCK) // BLOCK * BLOCK)


def block_maxima_plain(q, corpus, n_real: int, chunk: int) -> torch.Tensor:
    """Plain version of the maxima wrappers: ``[rows, ceil(n_real / BLOCK)]``."""
    return torch.cat([s.amax(dim=2) for _, s in _score_blocks(q, corpus, n_real, chunk)], dim=1)


def block_candidates_plain(q, corpus, n_real: int, chosen: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """Plain version of the candidates wrappers: ``[rows, k * BLOCK]``."""
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
# Each library's C entry points and their arguments; each returns an int.
_ENTRIES = {
    "search_prefilter.cu": {
        "tt_prefilter_maxima": [_P, _P, _I, _I, _I, _P, _P],
        "tt_prefilter_scratch": [_I, _I, _I, _P, _P],
        "tt_prefilter_candidates": [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    },
    "search_prefilter_f32.cu": {
        "tt_prefilter_f32_query_tile": [_I],
        "tt_prefilter_f32_maxima": [_P, _P, _I, _I, _I, _P, _P],
        "tt_prefilter_f32_candidates": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P],
    },
}


@cache
def _lib(source: str) -> ctypes.CDLL:
    lib = build.load(source)
    for name, argtypes in _ENTRIES[source].items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _check_cuda(p: Precision, q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> None:
    dim = corpus.shape[1]
    if not (q.dtype == corpus.dtype == p.dtype and q.is_contiguous()
            and corpus.is_contiguous() and q.dim() == corpus.dim() == 2 and q.shape[1] == dim):
        raise ValueError(
            f"{p.dtype} prefilter kernel: queries and corpus must be contiguous {p.dtype} "
            f"[rows, D] and [N, D], got {q.dtype} {tuple(q.shape)} and {corpus.dtype} "
            f"{tuple(corpus.shape)}")
    if not (dim % p.depth_multiple == 0 and 0 < dim <= MAX_DEPTH
            and 0 < n_real <= corpus.shape[0] < 2**31 and 0 < q.shape[0] < 2**31
            and q.data_ptr() % p.align == 0 and corpus.data_ptr() % p.align == 0):
        raise ValueError(f"{p.dtype} prefilter kernel does not cover rows={q.shape[0]}, D={dim}, "
                         f"n={n_real} of {corpus.shape[0]} (or an address not {p.align}-byte "
                         "aligned)")


def _kernel_or_plain(p: Precision, wrapper, plain, launch, q: torch.Tensor,
                     corpus: torch.Tensor, n_real: int, *chosen: torch.Tensor) -> torch.Tensor:
    """A wrapper's body: ``plain`` on CPU tensors, else ``launch`` (the
    kernels), counted as a launch of ``wrapper``."""
    if build.on_cpu("prefilter", q, corpus):
        return plain(q, corpus, n_real, *chosen, _plain_chunk(n_real))
    _check_cuda(p, q, corpus, n_real)
    # The library reads the current device for the kernels' shared-memory
    # opt-in and the SM count: a corpus shard on another card must be it.
    with torch.cuda.device(q.device):
        out = launch(q, corpus, n_real, *chosen)
    build.count(wrapper)
    return out


@build.counted
def block_maxima(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> torch.Tensor:
    """``[rows, ceil(n_real / BLOCK)]`` float32: each bfloat16 query row's
    maximum score over each ``BLOCK`` rows of the corpus's first ``n_real``.
    The kernel on CUDA tensors (the scores never reach device memory); the
    plain version on CPU tensors."""
    return _kernel_or_plain(BF16, block_maxima, block_maxima_plain, BF16.launch_maxima, q,
                            corpus, n_real)


@build.counted
def block_candidates(q: torch.Tensor, corpus: torch.Tensor, n_real: int,
                     chosen: torch.Tensor) -> torch.Tensor:
    """``[rows, k * BLOCK]`` float32: for each bfloat16 query row, its scores
    of each of the k blocks ``chosen[row]`` (distinct block indices, int64
    ``[rows, k]``), in that order; columns past ``n_real`` are ``-inf``. The
    kernels on CUDA tensors (the chosen blocks' ranks, then the scores of
    the corpus tiles some row chose); the plain version on CPU tensors."""
    return _kernel_or_plain(BF16, block_candidates, block_candidates_plain,
                            BF16.launch_candidates, q, corpus, n_real, chosen)


@build.counted
def block_maxima_f32(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> torch.Tensor:
    """``block_maxima`` of float32 query rows against a float32 corpus, at
    float32 accuracy."""
    return _kernel_or_plain(F32, block_maxima_f32, block_maxima_plain, F32.launch_maxima, q,
                            corpus, n_real)


@build.counted
def block_candidates_f32(q: torch.Tensor, corpus: torch.Tensor, n_real: int,
                         chosen: torch.Tensor) -> torch.Tensor:
    """``block_candidates`` of float32 query rows against a float32 corpus,
    at float32 accuracy: the kernel scores the chosen blocks alone
    (``work_items``)."""
    return _kernel_or_plain(F32, block_candidates_f32, block_candidates_plain,
                            F32.launch_candidates, q, corpus, n_real, chosen)


# The approx search's over a bfloat16 corpus and the two-pass search's over a
# float32 one: one launch each a launch of query rows (``topk_prefilter``).
WRAPPERS = (block_maxima, block_candidates, block_maxima_f32, block_candidates_f32)


def _bf16_candidates(q, corpus, n_real: int, chosen: torch.Tensor) -> torch.Tensor:
    """The bfloat16 candidates' kernels on the current card: the chosen
    blocks' ranks and the corpus tiles' flags into scratch, then the scores
    of the tiles some row chose."""
    rows, k = chosen.shape
    if (chosen.dtype != torch.int64 or rows != q.shape[0] or not chosen.is_contiguous()
            or chosen.device != q.device or not 0 < k < 2**15):
        raise ValueError(f"prefilter kernel: chosen must be a contiguous int64 [{q.shape[0]}, k] "
                         f"on {q.device}, k < 32768")
    lib = _lib(BF16.source)
    rank_len, flag_words = ctypes.c_longlong(), ctypes.c_longlong()
    build.raise_on(lib.tt_prefilter_scratch(rows, n_real, corpus.shape[1],
                                            ctypes.byref(rank_len), ctypes.byref(flag_words)),
                   "prefilter_scratch")
    rank = torch.full((rank_len.value,), -1, dtype=torch.int16, device=q.device)
    flags = torch.zeros(flag_words.value, dtype=torch.int32, device=q.device)
    out = torch.full((rows, k * BLOCK), float("-inf"), device=q.device)
    rc = lib.tt_prefilter_candidates(q.data_ptr(), corpus.data_ptr(), rows, n_real,
                                     corpus.shape[1], chosen.data_ptr(), k, rank.data_ptr(),
                                     flags.data_ptr(), out.data_ptr(), build.stream(q))
    build.raise_on(rc, "prefilter_candidates_kernel")
    return out


def work_items(chosen: torch.Tensor, nblk: int, tile: int):
    """The float32 candidates kernel's grid, from the rows' chosen blocks
    ``[rows, k]``: ``(order, bounds, work_end, work_block)``, the pairs ``r k
    + i`` sorted by block, each block's first pair ``[nblk + 1]``, the work
    items (``tile`` pairs of one block at a time) through each block
    ``[nblk]``, and each item's block (``nblk`` past the last item) for as
    many items as there can be: ``min(nblk, pairs) + ceil(pairs / tile)``.
    All on the card, with no read back to the host."""
    flat = chosen.reshape(-1)
    blocks, order = torch.sort(flat)
    dev = chosen.device
    bounds = torch.searchsorted(blocks, torch.arange(nblk + 1, device=dev))
    work_end = torch.cumsum((bounds[1:] - bounds[:-1] + tile - 1) // tile, 0)
    items = min(nblk, flat.numel()) + -(-flat.numel() // tile)
    work_block = torch.searchsorted(work_end, torch.arange(items, device=dev), right=True)
    return order, bounds, work_end, work_block


def _f32_candidates(q, corpus, n_real: int, chosen: torch.Tensor) -> torch.Tensor:
    """The float32 candidates kernel on the current card, over the chosen
    blocks alone (``work_items``)."""
    rows, k = chosen.shape
    if (chosen.dtype != torch.int64 or rows != q.shape[0] or chosen.device != q.device
            or not 0 < k < 2**31 // BLOCK):
        raise ValueError(f"float32 prefilter kernel: chosen must be int64 [{q.shape[0]}, k] on "
                         f"{q.device}")
    lib = _lib(F32.source)
    dim = corpus.shape[1]
    order, bounds, work_end, work_block = work_items(
        chosen, -(-n_real // BLOCK), lib.tt_prefilter_f32_query_tile(dim))
    out = torch.full((rows, k * BLOCK), float("-inf"), device=q.device)
    rc = lib.tt_prefilter_f32_candidates(
        q.data_ptr(), corpus.data_ptr(), rows, n_real, dim, k, order.data_ptr(),
        bounds.data_ptr(), work_end.data_ptr(), work_block.data_ptr(), work_block.numel(),
        out.data_ptr(), build.stream(q))
    build.raise_on(rc, "prefilter_f32_candidates_kernel")
    return out


def _bf16_launch_rows(b: int, n_real: int, k: int, budget: int) -> int:
    """Counting the maxima, the candidates' int16 ranks (``[rows, nblk]``
    rounded to even) and flags words (one a ``QUERY_TILE`` of rows and
    ``CORPUS_TILE`` of corpus), and the candidates together."""
    nblk = -(-n_real // BLOCK)
    per_row = nblk + (nblk + 1) // 2 + k * BLOCK
    tiles = -(-n_real // CORPUS_TILE)  # flags words a query tile
    # rows * per_row + ceil(rows / QUERY_TILE) * tiles <= budget, with
    # ceil(rows / QUERY_TILE) <= rows / QUERY_TILE + 1.
    rows = (budget - tiles) * QUERY_TILE // (per_row * QUERY_TILE + tiles)
    return max(1, min(b, rows))


def _f32_launch_rows(b: int, n_real: int, k: int, budget: int) -> int:
    """Counting a row's maxima and candidates, eight words a pair for its
    chosen blocks, their sorted copy, their order and the work items, and
    eight words a block for the work lists."""
    nblk = -(-n_real // BLOCK)
    per_row = nblk + k * (BLOCK + 8)
    return max(1, min(b, (budget - 8 * (nblk + 1)) // per_row))


@dataclass(frozen=True)
class Precision:
    """What differs between the prefilter's two precisions; the rest of the
    module serves both."""

    dtype: torch.dtype  # of the corpus, and of the queries the kernels take
    depth_multiple: int  # the kernels take depths of this multiple up to MAX_DEPTH
    align: int  # bytes the kernels need the queries' and corpus's addresses aligned to
    product: Callable  # the plain versions' scores: q -> (corpus chunk -> [rows, C] float32)
    source: str  # the kernels' CUDA source under ``ops/csrc/``
    maxima_entry: str  # the maxima kernel's C entry point
    launch_candidates: Callable  # (q, corpus, n_real, chosen) -> candidates, on the current card
    # Query rows a launch takes, of ``b``: as many as keep what the launch
    # holds on the card within ``budget`` float32 words; at least one.
    launch_rows: Callable[[int, int, int, int], int]
    maxima: Callable  # the counted wrappers
    candidates: Callable

    def launch_maxima(self, q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> torch.Tensor:
        """The maxima kernel on the current card."""
        out = torch.empty((q.shape[0], -(-n_real // BLOCK)), dtype=torch.float32,
                          device=q.device)
        rc = getattr(_lib(self.source), self.maxima_entry)(
            q.data_ptr(), corpus.data_ptr(), q.shape[0], n_real, corpus.shape[1],
            out.data_ptr(), build.stream(q))
        build.raise_on(rc, self.maxima_entry.removeprefix("tt_") + "_kernel")
        return out

    def applies(self, item_emb: torch.Tensor, k: int, n_real: int) -> bool:
        """Whether ``item_emb``'s first ``n_real`` rows are searched through
        this precision's prefilter: a corpus of its dtype, depth a multiple
        of ``depth_multiple`` up to ``MAX_DEPTH``, and more than ``4 k``
        blocks (``topk_mips_twopass``'s rule). The device picks kernel or
        plain version, nothing else."""
        dim = item_emb.shape[1]
        return (item_emb.dtype == self.dtype and dim % self.depth_multiple == 0
                and 0 < dim <= MAX_DEPTH and n_real > 4 * k * BLOCK)


# The float32 kernels' queries take 16-byte loads; the bfloat16 library
# checks its tensor maps' addresses itself.
BF16 = Precision(torch.bfloat16, 16, 1, _bf16_product, "search_prefilter.cu",
                 "tt_prefilter_maxima", _bf16_candidates, _bf16_launch_rows,
                 block_maxima, block_candidates)
F32 = Precision(torch.float32, 8, 16, _f32_product, "search_prefilter_f32.cu",
                "tt_prefilter_f32_maxima", _f32_candidates, _f32_launch_rows,
                block_maxima_f32, block_candidates_f32)
_PRECISIONS = {p.dtype: p for p in (BF16, F32)}


def topk_prefilter(query: torch.Tensor, corpus: torch.Tensor, k: int, n_real: int,
                   budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the scores of ``query`` against the corpus's first
    ``n_real`` rows, in the corpus's precision (``BF16`` or ``F32``):
    ``(scores [B, k] float32 descending, ids [B, k] int64)``. A launch takes
    ``launch_rows`` query rows, which keeps what it holds within ``budget``
    float32 words (the plain versions' score chunks too: ``_plain_chunk``)."""
    p = _PRECISIONS[corpus.dtype]
    b = query.shape[0]
    if b == 0:
        return (torch.zeros((0, k), device=corpus.device),
                torch.zeros((0, k), dtype=torch.long, device=corpus.device))
    rows = p.launch_rows(b, n_real, k, budget)
    query = query.to(p.dtype)
    out_vals, out_ids = [], []
    for start in range(0, b, rows):
        q = query[start:start + rows].contiguous()
        maxima = p.maxima(q, corpus, n_real)
        chosen = top_blocks(maxima, k)
        del maxima
        scores = p.candidates(q, corpus, n_real, chosen)
        top, pos = torch.topk(scores, k, dim=1)
        out_vals.append(top)
        out_ids.append(torch.gather(chosen, 1, pos // BLOCK) * BLOCK + pos % BLOCK)
    return torch.cat(out_vals), torch.cat(out_ids)

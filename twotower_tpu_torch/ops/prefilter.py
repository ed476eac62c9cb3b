"""Exact top-k over a bfloat16 corpus through a block-maxima prefilter:
``topk_mips_approx``'s path for a bfloat16 corpus of depth a multiple of 16
up to 256 and more than ``4 k`` blocks of ``BLOCK`` rows (``applies``).

Three steps a launch of query rows:

1. ``block_maxima``: each row's maximum score over each block of ``BLOCK``
   consecutive corpus rows, ``[rows, ceil(n / BLOCK)]`` float32.
2. ``top_blocks``: the row's k blocks of largest maximum (``torch.topk``,
   the counterpart of the JAX package's ``lax.top_k``, over the maxima of
   superblocks of ``SUPER`` blocks, then over the blocks of the k chosen).
3. ``block_candidates``: the row's scores of those k blocks, ``[rows, k *
   BLOCK]``, and the exact top-k of them.

Why it is exact (``topk_mips_twopass``'s argument): the top-k scores of a
row lie in at most k blocks, and a block holding one has a maximum at
least the k-th score, so the k blocks of largest maximum hold every top-k
score. Where blocks tie at the k-th maximum any choice among them does: a
top-k score of a block left out equals a score kept in its place. Steps 1
and 3 must compute every score bit for bit alike, which both forms do: the
kernels launch the same tiles in the same grid
(``ops/csrc/search_prefilter.cu``), and the plain versions multiply the same
chunks in the same shapes.

Scores are the queries in bfloat16 against the corpus in bfloat16,
accumulated in float32, as ``ops.topk._scores``: on the card the kernels'
tensor-core products, on the CPU both operands upcast to float32 (a product
of two bf16 values is exact there). Each wrapper takes its plain version
only for tensors on the CPU; for CUDA tensors it launches its kernels, with
the tensors' card as the current device, or raises. Each counts its launches
in ``<wrapper>.launches``, through ``ops.kernels``' launch counts
(``kernels.SEARCH_WRAPPERS``, reset by ``kernels.reset_launch_counts``).
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch
import torch.nn.functional as F


BLOCK = 64  # corpus rows a block maximum covers (the kernels' block)
SUPER = 16  # blocks a superblock of the select covers
MAX_DEPTH = 256
QUERY_TILE = 256  # query rows a kernel block holds (kBM), and so a flags word's rows
CORPUS_TILE = 128  # corpus rows a kernel tile covers (kBN): two blocks


def applies(item_emb: torch.Tensor, k: int, n_real: int) -> bool:
    """Whether ``topk_mips_approx`` searches ``item_emb``'s first ``n_real``
    rows through the prefilter: a bfloat16 corpus, depth a multiple of 16
    up to ``MAX_DEPTH``, and more than ``4 k`` blocks (``topk_mips_twopass``'s
    rule). The device picks kernel or plain version, nothing else."""
    dim = item_emb.shape[1]
    return (item_emb.dtype == torch.bfloat16 and dim % 16 == 0 and 0 < dim <= MAX_DEPTH
            and n_real > 4 * k * BLOCK)


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


def _score_blocks(q: torch.Tensor, corpus: torch.Tensor, n_real: int, chunk: int):
    """``(first block, [rows, blocks, BLOCK] float32 scores)`` of the corpus
    rows below ``n_real``, ``chunk`` (a ``BLOCK`` multiple) rows at a time;
    the last block's columns past ``n_real`` are ``-inf``."""
    qf = q.to(torch.bfloat16).float()
    for lo in range(0, n_real, chunk):
        s = qf @ corpus[lo:min(lo + chunk, n_real)].float().T
        s = F.pad(s, (0, -s.shape[1] % BLOCK), value=float("-inf"))
        yield lo // BLOCK, s.view(s.shape[0], -1, BLOCK)


def _plain_chunk(n_real: int) -> int:
    """The plain versions' corpus rows a chunk: as many as there are blocks
    (a ``BLOCK`` multiple, at least one block), so that a chunk's scores
    take no more room than the maxima or the candidates."""
    return max(BLOCK, -(-n_real // BLOCK) // BLOCK * BLOCK)


def block_maxima_plain(q, corpus, n_real: int, chunk: int) -> torch.Tensor:
    """Plain version of ``block_maxima``: ``[rows, ceil(n_real / BLOCK)]``."""
    return torch.cat([s.amax(dim=2) for _, s in _score_blocks(q, corpus, n_real, chunk)], dim=1)


def block_candidates_plain(q, corpus, n_real: int, chosen: torch.Tensor,
                           chunk: int) -> torch.Tensor:
    """Plain version of ``block_candidates``: ``[rows, k * BLOCK]``."""
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

    lib = build.load("search_prefilter.cu")
    lib.tt_prefilter_maxima.argtypes = [_P, _P, _I, _I, _I, _P, _P]
    lib.tt_prefilter_maxima.restype = ctypes.c_int
    lib.tt_prefilter_scratch.argtypes = [_I, _I, _I, _P, _P]
    lib.tt_prefilter_scratch.restype = ctypes.c_int
    lib.tt_prefilter_candidates.argtypes = [_P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P]
    lib.tt_prefilter_candidates.restype = ctypes.c_int
    return lib


def _on_cpu(q: torch.Tensor, corpus: torch.Tensor) -> bool:
    if q.device.type == corpus.device.type == "cpu":
        return True
    if q.device != corpus.device or q.device.type != "cuda":
        raise ValueError(f"prefilter inputs must share one CPU or CUDA device, got "
                         f"{q.device} and {corpus.device}")
    return False


def _check_cuda(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> None:
    dim = corpus.shape[1]
    if not (q.dtype == corpus.dtype == torch.bfloat16 and q.is_contiguous()
            and corpus.is_contiguous() and q.dim() == corpus.dim() == 2 and q.shape[1] == dim):
        raise ValueError(
            f"prefilter kernel: queries and corpus must be contiguous bfloat16 [rows, D] and "
            f"[N, D], got {q.dtype} {tuple(q.shape)} and {corpus.dtype} {tuple(corpus.shape)}")
    if not (dim % 16 == 0 and 0 < dim <= MAX_DEPTH and 0 < n_real <= corpus.shape[0] < 2**31
            and 0 < q.shape[0] < 2**31):
        raise ValueError(f"prefilter kernel does not cover rows={q.shape[0]}, D={dim}, "
                         f"n={n_real} of {corpus.shape[0]}")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(wrapper) -> None:
    # Imported here, as ``_lib``'s build: the CPU path loads neither.
    from twotower_tpu_torch.ops import kernels

    kernels._count(wrapper)


def block_maxima(q: torch.Tensor, corpus: torch.Tensor, n_real: int) -> torch.Tensor:
    """``[rows, ceil(n_real / BLOCK)]`` float32: each bfloat16 query row's
    maximum score over each ``BLOCK`` rows of the corpus's first ``n_real``.
    The kernel on CUDA tensors (the scores never reach device memory); the
    plain version on CPU tensors."""
    if _on_cpu(q, corpus):
        return block_maxima_plain(q, corpus, n_real, _plain_chunk(n_real))
    _check_cuda(q, corpus, n_real)
    rows = q.shape[0]
    out = torch.empty((rows, -(-n_real // BLOCK)), dtype=torch.float32, device=q.device)
    # The library reads the current device for the kernels' shared-memory
    # opt-in and the SM count: a corpus shard on another card must be it.
    with torch.cuda.device(q.device):
        rc = _lib().tt_prefilter_maxima(q.data_ptr(), corpus.data_ptr(), rows, n_real,
                                        corpus.shape[1], out.data_ptr(), _stream(q))
    _raise_on(rc, "prefilter_maxima_kernel")
    _count(block_maxima)
    return out


def block_candidates(q: torch.Tensor, corpus: torch.Tensor, n_real: int,
                     chosen: torch.Tensor) -> torch.Tensor:
    """``[rows, k * BLOCK]`` float32: for each bfloat16 query row, its scores
    of each of the k blocks ``chosen[row]`` (distinct block indices, int64
    ``[rows, k]``), in that order; columns past ``n_real`` are ``-inf``. The
    kernels on CUDA tensors (the chosen blocks' ranks, then the scores of
    the corpus tiles some row chose); the plain version on CPU tensors."""
    if _on_cpu(q, corpus):
        return block_candidates_plain(q, corpus, n_real, chosen, _plain_chunk(n_real))
    _check_cuda(q, corpus, n_real)
    rows, k = chosen.shape
    if (chosen.dtype != torch.int64 or rows != q.shape[0] or not chosen.is_contiguous()
            or chosen.device != q.device or not 0 < k < 2**15):
        raise ValueError(f"prefilter kernel: chosen must be a contiguous int64 [{q.shape[0]}, k] "
                         f"on {q.device}, k < 32768")
    lib = _lib()
    rank_len, flag_words = ctypes.c_longlong(), ctypes.c_longlong()
    with torch.cuda.device(q.device):  # as block_maxima's
        _raise_on(lib.tt_prefilter_scratch(rows, n_real, corpus.shape[1],
                                           ctypes.byref(rank_len), ctypes.byref(flag_words)),
                  "prefilter_scratch")
        rank = torch.full((rank_len.value,), -1, dtype=torch.int16, device=q.device)
        flags = torch.zeros(flag_words.value, dtype=torch.int32, device=q.device)
        out = torch.full((rows, k * BLOCK), float("-inf"), device=q.device)
        rc = lib.tt_prefilter_candidates(q.data_ptr(), corpus.data_ptr(), rows, n_real,
                                         corpus.shape[1], chosen.data_ptr(), k, rank.data_ptr(),
                                         flags.data_ptr(), out.data_ptr(), _stream(q))
    _raise_on(rc, "prefilter_candidates_kernel")
    _count(block_candidates)
    return out


block_maxima.launches = 0
block_candidates.launches = 0


def launch_rows(b: int, n_real: int, k: int, budget: int) -> int:
    """Query rows a launch takes, of ``b``: as many as keep what the launch
    holds on the card within ``budget`` float32 words, counting the maxima,
    the candidates' int16 ranks (``[rows, nblk]`` rounded to even) and flags
    words (one a ``QUERY_TILE`` of rows and ``CORPUS_TILE`` of corpus), and
    the candidates together; at least one."""
    nblk = -(-n_real // BLOCK)
    per_row = nblk + (nblk + 1) // 2 + k * BLOCK
    tiles = -(-n_real // CORPUS_TILE)  # flags words a query tile
    # rows * per_row + ceil(rows / QUERY_TILE) * tiles <= budget, with
    # ceil(rows / QUERY_TILE) <= rows / QUERY_TILE + 1.
    rows = (budget - tiles) * QUERY_TILE // (per_row * QUERY_TILE + tiles)
    return max(1, min(b, rows))


def topk_prefilter(query: torch.Tensor, corpus: torch.Tensor, k: int, n_real: int,
                   budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact top-k of the bfloat16 scores of ``query`` against the
    corpus's first ``n_real`` rows: ``(scores [B, k] float32 descending,
    ids [B, k] int64)``. A launch takes ``launch_rows`` query rows, which
    keeps what it holds within ``budget`` float32 words (the plain versions'
    score chunks too: ``_plain_chunk``)."""
    b = query.shape[0]
    rows = launch_rows(b, n_real, k, budget)
    query = query.to(torch.bfloat16)
    out_vals, out_ids = [], []
    for start in range(0, b, rows):
        q = query[start:start + rows].contiguous()
        maxima = block_maxima(q, corpus, n_real)
        chosen = top_blocks(maxima, k)
        del maxima
        scores = block_candidates(q, corpus, n_real, chosen)
        top, pos = torch.topk(scores, k, dim=1)
        out_vals.append(top)
        out_ids.append(torch.gather(chosen, 1, pos // BLOCK) * BLOCK + pos % BLOCK)
    return torch.cat(out_vals), torch.cat(out_ids)

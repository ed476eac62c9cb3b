"""Exact maximum-inner-product top-k over an item corpus (PyTorch).

Counterpart of the exact part of ``twotower_tpu/ops/topk.py``: the chunked
scan ``topk_mips`` and the two-pass search ``topk_mips_twopass`` (block
maxima prefilter, then an exact rescore of the candidate blocks). These are
XLA ops in the JAX package, not Pallas kernels, so they port to
``torch.matmul`` and ``torch.topk``.

Scores are true float32 products: the JAX code asks for
``Precision.HIGHEST``, and the CUDA counterpart is TF32 off for the
products. Every product here runs inside ``float32_products()``, which
holds ``torch.backends.cuda.matmul.allow_tf32`` false for its duration and
restores the caller's setting after.

The corpus is read in slices, never padded by a copy: a slice past the last
real row is simply shorter, and rows at index >= ``num_valid`` are never
scored, so they never surface. Tie order: ``lax.top_k`` prefers the lower
index among equal scores; ``torch.topk`` leaves it unspecified, so among
exactly tied scores the two packages may return different (equally scored)
ids.
"""

from __future__ import annotations

import contextlib

import torch


def exact_padded_rows(n: int, *, chunk_size: int = 131072) -> int:
    """Corpus row count for a resident exact-search corpus: ``n`` below
    ~1M rows, else rounded up to the two-pass chunk (the JAX package's
    rule; the port's searches slice instead of padding, so this only sizes
    memory budgets)."""
    if n < 1 << 20:
        return n
    return -(-n // chunk_size) * chunk_size


def exact_scan_chunk(batch_rows: int) -> int:
    """Corpus-stream chunk for the exact searches, given the query batch:
    a power of two in [8192, 131072] bounded by a 2 GB ``batch_rows x chunk
    x 4`` score buffer. The one formula shared with ``Evaluator``."""
    mem_cap = (2 << 30) // (4 * max(batch_rows, 1))
    capped = min(131072, max(8192, mem_cap))
    return 1 << (capped.bit_length() - 1)


@contextlib.contextmanager
def float32_products():
    """TF32 off for the enclosed float32 products (restored after)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _check(n: int, k: int, num_valid: int | None) -> int:
    n_real = n if num_valid is None else num_valid
    if not 0 < n_real <= n:
        raise ValueError(f"num_valid={num_valid} out of range for corpus size {n}")
    if k > n_real:
        raise ValueError(f"k={k} exceeds corpus size {n_real}")
    return n_real


def _chunk_scores(query: torch.Tensor, item_emb: torch.Tensor, base: int, size: int,
                  n_real: int, multiple: int = 1) -> torch.Tensor:
    """``[B, C]`` float32 scores of the corpus rows ``[base, base + size)``
    that lie below ``n_real`` (rows past it are never scored), with ``C``
    rounded up to ``multiple`` by ``-inf`` columns. The rounding pads the
    corpus slice (``C x D``), not the scores (``B x C``): a copy of a few
    MB instead of a few GB."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("exact search needs TF32 off (run inside float32_products())")
    chunk = item_emb[base : min(base + size, n_real)]
    rows = chunk.shape[0]
    pad = -rows % multiple
    if pad:
        chunk = torch.nn.functional.pad(chunk, (0, 0, 0, pad))
    scores = (query.to(chunk.dtype) @ chunk.T).float()
    if pad:
        scores[:, rows:] = float("-inf")
    return scores


def _merge(top_vals, top_idx, c_vals, c_idx, k: int):
    """Running top-k merged with one chunk's top-k."""
    vals, sel = torch.topk(torch.cat([top_vals, c_vals], dim=1), k, dim=1)
    return vals, torch.gather(torch.cat([top_idx, c_idx], dim=1), 1, sel)


def _topk_mips_scan(query, item_emb, k: int, chunk_size: int, n_real: int):
    """Exact chunked-scan core: a running top-k merged chunk by chunk."""
    n = item_emb.shape[0]
    chunk_size = min(chunk_size, -(-n // 128) * 128)
    # each step takes a top-k over one chunk: the chunk must hold >= k
    chunk_size = max(chunk_size, -(-k // 128) * 128)
    batch = query.shape[0]
    dev = query.device
    top_vals = torch.full((batch, k), float("-inf"), device=dev)
    top_idx = torch.full((batch, k), -1, dtype=torch.long, device=dev)
    with float32_products():
        for base in range(0, n_real, chunk_size):
            scores = _chunk_scores(query, item_emb, base, chunk_size, n_real)
            c_vals, c_pos = torch.topk(scores, min(k, scores.shape[1]), dim=1)
            top_vals, top_idx = _merge(top_vals, top_idx, c_vals, c_pos + base, k)
    return top_vals, top_idx


def topk_mips(
    query_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    *,
    chunk_size: int = 8192,
    num_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner-product search.

    Args:
      query_emb: ``[B, D]`` queries.
      item_emb: ``[N, D]`` corpus, read in slices of ``chunk_size`` rows
        (peak memory ``B * chunk_size`` scores).
      k: number of neighbours.
      num_valid: real corpus rows when ``item_emb`` was pre-padded; rows at
        index >= num_valid never surface.

    Returns:
      (scores ``[B, k]`` float32 descending, indices ``[B, k]`` int64).
    """
    n_real = _check(item_emb.shape[0], k, num_valid)
    return _topk_mips_scan(query_emb, item_emb, k, chunk_size, n_real)


def topk_mips_twopass(
    query_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    *,
    chunk_size: int = 131072,
    block: int = 64,
    num_valid: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k MIPS via a block-maxima prefilter.

    Streams the corpus once; for each chunk of scores it takes the
    maximum of every ``block`` contiguous rows, keeps the top-k **blocks**
    by maximum (a small top-k over ``C / block`` columns instead of ``C``)
    together with those blocks' scores, and merges them into a running
    top-k of blocks. The exact top-k is then taken over the ``k x block``
    kept scores.

    Correctness: the true top-k elements occupy at most ``k`` distinct
    blocks, and any block containing one has max >= the k-th score, so the
    top-k blocks by maximum cover every top-k element. The JAX package's
    second pass gathers the candidate rows and rescores them with a batched
    matrix-vector product, whose summation order differs from the chunk
    product's (about 1e-6 relative on the H100 at D=128, and some 13 GB of
    gathered rows at B=4096, k=100); here the kept scores ARE the chunk
    product's, so they equal ``query @ item_emb.T`` bit for bit and no row
    is gathered. Ties exactly at the k-th score may resolve to another,
    equally scored, id. Small corpora (at most ``4 k`` blocks) take the
    plain scan.
    """
    n = item_emb.shape[0]
    n_real = _check(n, k, num_valid)
    if block > chunk_size:
        raise ValueError(f"block={block} exceeds chunk_size={chunk_size}")
    # A block multiple (the block reshape needs it).
    chunk_size = chunk_size // block * block
    if n_real <= 4 * k * block:
        return _topk_mips_scan(query_emb, item_emb, k, chunk_size, n_real)
    return _twopass_core(query_emb, item_emb, k, chunk_size, block, n_real)


def _twopass_core(query, item_emb, k: int, chunk_size: int, block: int, n_real: int):
    batch = query.shape[0]
    dev = query.device
    # Running top-k blocks: maxima [B, k], global block ids [B, k], and the
    # blocks' scores [B, k, block]. The initial slots score -inf throughout,
    # and more than 4 k blocks hold a real row, so they never surface.
    top_max = torch.full((batch, k), float("-inf"), device=dev)
    top_blk = torch.zeros((batch, k), dtype=torch.long, device=dev)
    top_rows = torch.full((batch, k, block), float("-inf"), device=dev)
    with float32_products():
        for base in range(0, n_real, chunk_size):
            # The corpus's last, ragged block is padded by -inf columns.
            scores = _chunk_scores(query, item_emb, base, chunk_size, n_real, block)
            nb = scores.shape[1] // block
            rows = scores.view(batch, nb, block)
            c_max, c_pos = torch.topk(rows.amax(dim=2), min(k, nb), dim=1)
            c_rows = torch.gather(rows, 1, c_pos[:, :, None].expand(-1, -1, block))
            top_max, sel = torch.topk(torch.cat([top_max, c_max], dim=1), k, dim=1)
            top_blk = torch.gather(torch.cat([top_blk, c_pos + base // block], dim=1), 1, sel)
            top_rows = torch.gather(torch.cat([top_rows, c_rows], dim=1), 1,
                                    sel[:, :, None].expand(-1, -1, block))
    vals, pos = torch.topk(top_rows.reshape(batch, k * block), k, dim=1)
    ids = torch.gather(top_blk, 1, pos // block) * block + pos % block
    return vals, ids

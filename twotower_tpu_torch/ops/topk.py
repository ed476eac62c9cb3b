"""Maximum-inner-product top-k over an item corpus (PyTorch).

Counterpart of the single-device searches of ``twotower_tpu/ops/topk.py``:
the exact chunked scan ``topk_mips``, the two-pass search
``topk_mips_twopass`` (block maxima prefilter, then the exact top-k of the
candidate blocks), and the serving search ``topk_mips_approx`` over a
corpus resident in float32, bfloat16 or int8 (``quantize_corpus``). These
are XLA ops in the JAX package, not Pallas kernels, so they port to library
products and ``torch.topk``, except the serving search over a large
bfloat16 corpus, which goes through the block-maxima prefilter of
``ops/prefilter.py`` (a kernel on the card that keeps the scores on chip),
and, on the card, the two-pass search over a large float32 corpus, which
goes through its float32 twin, ``ops/prefilter_f32.py``.

Scores are float32. A float32 corpus is multiplied with TF32 off (the JAX
exact code asks for ``Precision.HIGHEST``): every product runs inside
``float32_products()``, which holds the process-wide TF32 switch off while
any thread is inside and restores the caller's setting after (the switch is
``torch.backends.cuda.matmul.fp32_precision`` where PyTorch has it, else the
legacy ``allow_tf32``); the float32 prefilter's kernels instead take
three TF32 tensor-core passes of split operands, which keep float32
accuracy (``ops/prefilter_f32.py``).
A bfloat16 corpus meets bfloat16 queries and accumulates in float32,
returned in float32, never rounded to bfloat16 (``_scores``). An int8
corpus meets per-row quantized queries in exact integer arithmetic.

The corpus is read in slices, never padded by a copy: a slice past the last
real row is simply shorter, and rows at index >= ``num_valid`` are never
scored, so they never surface. Tie order: ``lax.top_k`` prefers the lower
index among equal scores; ``torch.topk`` leaves it unspecified, so among
exactly tied scores the two packages may return different (equally scored)
ids.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F

from twotower_tpu_torch.ops import prefilter, prefilter_f32
from twotower_tpu_torch.utils import profiling


def exact_padded_rows(n: int, *, chunk_size: int = 131072) -> int:
    """Corpus row count for a resident exact-search corpus: ``n`` below
    ~1M rows, else rounded up to the two-pass chunk (the JAX package's
    rule; the port's searches slice instead of padding, so this only sizes
    memory budgets)."""
    if n < 1 << 20:
        return n
    return -(-n // chunk_size) * chunk_size


def _blocked_layout(n: int, item_chunk: int, k: int) -> tuple[int, int]:
    """Equal-size 128-multiple item blocks covering ``n`` rows:
    ``ceil(n / item_chunk)`` blocks of ``ceil(n / num_blocks)`` rows rounded
    up to 128 (and to hold ``k``). A 10M corpus is five 2,000,000-row
    blocks. The JAX package's layout, so both search the same blocks."""
    num_blocks = -(-n // item_chunk)
    per_block = -(-n // num_blocks)
    block = -(-per_block // 128) * 128
    block = max(block, -(-k // 128) * 128)
    return num_blocks, block


def ann_padded_rows(n: int, *, item_chunk: int = 1 << 21, k: int = 2048) -> int:
    """Corpus rows of a resident ``topk_mips_approx`` corpus: ``n`` when it
    fits one item block, else the blocked layout's rows (the JAX package's
    rule; its search reshapes such a corpus for free, the port's reads
    slices either way). ``k`` bounds the served ``k`` (only its rounding to
    128 matters)."""
    if n <= item_chunk:
        return n
    num_blocks, block = _blocked_layout(n, item_chunk, k)
    return num_blocks * block


def exact_scan_chunk(batch_rows: int) -> int:
    """Corpus-stream chunk for the exact searches, given the query batch:
    a power of two in [8192, 131072] bounded by a 2 GB ``batch_rows x chunk
    x 4`` score buffer. The one formula shared with ``Evaluator``."""
    mem_cap = (2 << 30) // (4 * max(batch_rows, 1))
    capped = min(131072, max(8192, mem_cap))
    return 1 << (capped.bit_length() - 1)


_MATMUL = torch.backends.cuda.matmul
# PyTorch 2.9 and later: ``fp32_precision`` ("ieee", "tf32" or "none", the
# latter inheriting the global ``torch.backends.fp32_precision``). Once a
# process sets it, reading the legacy ``allow_tf32`` raises, so where it
# exists the guard reads and writes it alone.
_NEW_TF32_API = hasattr(_MATMUL, "fp32_precision")


def matmul_tf32() -> bool:
    """Whether float32 CUDA products may use TF32 now, read through the API
    this PyTorch has (never the legacy flag where the new one exists)."""
    if _NEW_TF32_API:
        return _MATMUL.fp32_precision == "tf32"
    return bool(_MATMUL.allow_tf32)


class _TF32Off:
    """Holds the process-wide TF32 switch off while any thread is inside
    ``float32_products()``: the first to enter saves the caller's setting,
    the last to leave restores it. A save and restore per thread would let
    one thread restore TF32 while another is mid-product (the serving front
    searches from several executor threads at once)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._depth = 0
        self._saved: str | bool = False

    def enter(self) -> None:
        with self._lock:
            if self._depth == 0:
                if _NEW_TF32_API:
                    self._saved = _MATMUL.fp32_precision
                    _MATMUL.fp32_precision = "ieee"
                else:
                    self._saved = _MATMUL.allow_tf32
                    _MATMUL.allow_tf32 = False
            self._depth += 1

    def leave(self) -> None:
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                if _NEW_TF32_API:
                    _MATMUL.fp32_precision = self._saved
                else:
                    _MATMUL.allow_tf32 = self._saved


# One guard for the process, as the flag it guards is one for the process.
_TF32_OFF = _TF32Off()


@contextlib.contextmanager
def float32_products():
    """TF32 off for the enclosed float32 products; the caller's setting is
    restored when the last thread inside leaves."""
    _TF32_OFF.enter()
    try:
        yield
    finally:
        _TF32_OFF.leave()


def _check(n: int, k: int, num_valid: int | None) -> int:
    n_real = n if num_valid is None else num_valid
    if not 0 < n_real <= n:
        raise ValueError(f"num_valid={num_valid} out of range for corpus size {n}")
    if k > n_real:
        raise ValueError(f"k={k} exceeds corpus size {n_real}")
    return n_real


def _scores(query: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` float32 scores of float queries against float corpus rows.

    The queries meet the corpus in its dtype, as in the JAX searches. A
    float32 corpus is one float32 product (TF32 must be off). A bfloat16
    corpus accumulates in float32 and returns float32: on the card a bf16
    tensor-core product with float32 output; on the CPU, where
    ``mm(out_dtype=)`` has no kernel, both operands are upcast (a product of
    two bf16 values is exact in float32, so the two differ in summation
    order only). A bf16 matmul returning bf16 would round every score to 8
    significant bits before the top-k."""
    if chunk.dtype == torch.float32:
        if matmul_tf32():
            raise RuntimeError("float32 search needs TF32 off (run inside float32_products())")
        return query.float() @ chunk.T
    if chunk.dtype != torch.bfloat16:
        raise TypeError(
            f"float queries meet a float32 or bfloat16 corpus, not {chunk.dtype}; an int8 "
            "corpus is searched by topk_mips_approx with item_scale= (see quantize_corpus)"
        )
    query = query.to(torch.bfloat16)
    if chunk.is_cuda:
        return torch.mm(query, chunk.T, out_dtype=torch.float32)
    return query.float() @ chunk.float().T


# int8 x int8 sums stay below 2^24, so exact in float32 (and bf16 holds any
# int8 exactly), while D * 127^2 < 2^24.
_EXACT_FLOAT_DEPTH = 1040


def _int8_scores(query: torch.Tensor, chunk: torch.Tensor) -> torch.Tensor:
    """``[B, C]`` exact integer scores of int8 queries against int8 corpus
    rows: the JAX package's s8 x s8 -> s32 product.

    ``torch._int_mm`` where its CUDA shape rules allow (depth a multiple of
    8): zero rows pad the queries past 16 rows and a corpus slice to a
    multiple of 8 rows, so callers hand a ragged tail of under 8 rows over
    on its own (``_slices``) rather than have a whole block copied here.
    Otherwise a bf16 product with float32 output, exact up to
    ``_EXACT_FLOAT_DEPTH``."""
    b, d = query.shape
    rows = chunk.shape[0]
    if d % 8 == 0:
        if b <= 16:
            query = F.pad(query, (0, 0, 0, 17 - b))
        if rows % 8:
            chunk = F.pad(chunk, (0, 0, 0, -rows % 8))
        return torch._int_mm(query, chunk.T)[:b, :rows]
    if d > _EXACT_FLOAT_DEPTH:
        raise ValueError(
            f"int8 search at depth {d}: neither torch._int_mm (depth a multiple of 8) "
            f"nor an exact float32 accumulation (depth <= {_EXACT_FLOAT_DEPTH}) applies"
        )
    return _scores(query.to(torch.bfloat16), chunk.to(torch.bfloat16))


def _chunk_scores(query: torch.Tensor, item_emb: torch.Tensor, base: int, size: int,
                  n_real: int, multiple: int = 1) -> torch.Tensor:
    """``[B, C]`` float32 scores of the corpus rows ``[base, base + size)``
    that lie below ``n_real`` (rows past it are never scored), with ``C``
    rounded up to ``multiple`` by ``-inf`` columns. The rounding pads the
    corpus slice (``C x D``), not the scores (``B x C``): a copy of a few
    MB instead of a few GB."""
    chunk = item_emb[base : min(base + size, n_real)]
    rows = chunk.shape[0]
    pad = -rows % multiple
    if pad:
        chunk = F.pad(chunk, (0, 0, 0, pad))
    scores = _scores(query, chunk)
    if pad:
        scores[:, rows:] = float("-inf")
    return scores


def _merge(top_vals, top_idx, c_vals, c_idx, k: int):
    """Running top-k merged with one chunk's top-k (fewer than ``k`` while
    fewer than ``k`` candidates have been seen)."""
    vals = torch.cat([top_vals, c_vals], dim=1)
    vals, sel = torch.topk(vals, min(k, vals.shape[1]), dim=1)
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
            del scores  # one [B, chunk] score buffer alive at a time, not two
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
    gathered rows at B=4096, k=100); here the kept scores ARE the ones the
    block maxima were taken over, and no row is gathered. On the CPU they
    are the chunk product's, so they equal ``query @ item_emb.T`` bit for
    bit. On the card a float32 corpus of depth a multiple of 8 up to 256
    (``prefilter_f32.applies``, ``block`` 64) goes through the float32
    prefilter's kernels inside the span ``search.twopass_prefilter``: three
    TF32 tensor-core passes of split operands, float32-accurate but not
    bit for bit a float32 product, each score independent of the batch and
    of how it is cut into launches; ``chunk_size`` then only bounds the
    memory (``batch x chunk_size`` float32 words, the scan's score buffer).
    Ties exactly at the k-th score may resolve to another, equally scored,
    id. Small corpora (at most ``4 k`` blocks) take the plain scan.
    """
    n = item_emb.shape[0]
    n_real = _check(n, k, num_valid)
    if block > chunk_size:
        raise ValueError(f"block={block} exceeds chunk_size={chunk_size}")
    if _on_the_float32_prefilter(item_emb, k, block, n_real):
        with profiling.span("search.twopass_prefilter"):
            return prefilter_f32.topk_prefilter_f32(
                query_emb, item_emb[:n_real].contiguous(), k, n_real,
                query_emb.shape[0] * chunk_size)
    # A block multiple (the block reshape needs it).
    chunk_size = chunk_size // block * block
    if n_real <= 4 * k * block:
        return _topk_mips_scan(query_emb, item_emb, k, chunk_size, n_real)
    return _twopass_core(query_emb, item_emb, k, chunk_size, block, n_real)


def _on_the_float32_prefilter(item_emb: torch.Tensor, k: int, block: int, n_real: int) -> bool:
    """Whether ``topk_mips_twopass`` takes the float32 prefilter: a corpus on
    the card that ``prefilter_f32.applies`` to, at its block of 64 rows. On
    the CPU the search stays the chunked scan of the blocks."""
    return (item_emb.device.type == "cuda" and block == prefilter_f32.BLOCK
            and prefilter_f32.applies(item_emb, k, n_real))


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
            del scores, rows  # one [B, chunk] score buffer alive at a time, not two
            top_max, sel = torch.topk(torch.cat([top_max, c_max], dim=1), k, dim=1)
            top_blk = torch.gather(torch.cat([top_blk, c_pos + base // block], dim=1), 1, sel)
            top_rows = torch.gather(torch.cat([top_rows, c_rows], dim=1), 1,
                                    sel[:, :, None].expand(-1, -1, block))
    vals, pos = torch.topk(top_rows.reshape(batch, k * block), k, dim=1)
    ids = torch.gather(top_blk, 1, pos // block) * block + pos % block
    return vals, ids


def _inverse(scale: torch.Tensor) -> torch.Tensor:
    """``1 / scale``, and 0 where the scale is 0."""
    return torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30), torch.zeros_like(scale))


def _absmax_scale(x: torch.Tensor, dim: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scale, 1 / scale)`` of symmetric int8 quantization: scale =
    max |x| / 127, and 0 where it is 0. ``max(max x, -min x)`` is ``max |x|``
    without an ``|x|`` copy of a multi-GB corpus."""
    if dim is None:
        absmax = torch.maximum(x.amax(), -x.amin())
    else:
        absmax = torch.maximum(x.amax(dim=dim), -x.amin(dim=dim))
    scale = absmax / 127.0
    return scale, _inverse(scale)


def _round_to_int8(scaled: torch.Tensor) -> torch.Tensor:
    """Round half to even (as ``jnp.round``) and clip to [-127, 127], in
    place on ``scaled``."""
    return scaled.round_().clamp_(-127, 127).to(torch.int8)


def corpus_scale(parts) -> torch.Tensor:
    """The global int8 scale (max |x| / 127) of a corpus held in parts (the
    shards of a sharded index), on the first part's device: the scale
    ``quantize_corpus`` takes of the whole corpus."""
    dev = parts[0].device
    absmax = torch.stack([torch.maximum(x.amax(), -x.amin()).float().to(dev) for x in parts])
    return absmax.amax() / 127.0


def quantize_corpus(item_emb: torch.Tensor, *, per_row: bool = False,
                    scale: torch.Tensor | None = None):
    """Symmetric int8 quantization of a corpus: ``(q [N, D] int8, scale)``
    with ``q * scale ~= item_emb``, as the JAX ``quantize_corpus``.

    ``per_row=False``: one float32 scale (a 0-d tensor) for the corpus
    (``scale`` when given: a shard of a corpus quantized with the whole
    corpus's, ``corpus_scale``); raw integer scores are then monotonic in
    the true scores per query row, so the search applies the scale to the
    final ``[B, k]`` values only. ``per_row=True``: a float32 scale per row
    (``[N]``), which multiplies the scores before the top-k; all-zero rows
    (layout padding) get 0."""
    x = item_emb.float()
    if per_row:
        scale, inv = _absmax_scale(x, dim=1)
        return _round_to_int8(x * inv[:, None]), scale
    if scale is None:
        scale, inv = _absmax_scale(x)
    else:
        scale = scale.to(x.device)
        inv = _inverse(scale)
    return _round_to_int8(x * inv), scale


def _quantize_queries(query_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization of the queries (same scheme)."""
    q = query_emb.float()
    scale, inv = _absmax_scale(q, dim=1)
    return _round_to_int8(q * inv[:, None]), scale


def _slices(n_valid: int, block_rows: int, split_tail: bool):
    """``(lo, hi)`` corpus slices of each block below ``n_valid``; with
    ``split_tail`` a block's ragged last rows (under 8) form a slice of their
    own, so ``_int8_scores`` pads a few rows, never a block."""
    for base in range(0, n_valid, block_rows):
        hi = min(base + block_rows, n_valid)
        tail = (hi - base) % 8 if split_tail and hi - base > 8 else 0
        yield base, hi - tail
        if tail:
            yield hi - tail, hi


def topk_mips_approx(
    query_emb: torch.Tensor,
    item_emb: torch.Tensor,
    k: int,
    *,
    recall_target: float = 0.95,
    query_chunk: int = 256,
    item_chunk: int = 1 << 21,
    num_valid: int | None = None,
    item_scale: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a corpus resident in float32, bfloat16 or int8: the
    serving search, counterpart of the JAX ``topk_mips_approx``.

    The JAX search takes ``lax.approx_max_k``, a TPU primitive that every
    other JAX backend computes as an exact top-k. So does this one: each
    block's top-k is an exact ``torch.topk``, and ``recall_target`` is
    validated and has no other effect. The results differ from the exact
    float32 search only through the corpus's resident precision.

    Memory is bounded as in JAX: ``query_chunk x item_chunk`` float32 scores
    at most. A query block of ``chunk = min(query_chunk, B)`` rows scores
    the whole corpus at once when ``N * chunk <= query_chunk * item_chunk``;
    otherwise it scores equal item blocks (``_blocked_layout``) and merges
    their top-ks exactly.

    A bfloat16 corpus meets bfloat16 queries, accumulating and returning
    float32 (``_scores``). Where ``prefilter.applies`` (depth a multiple of
    16 up to 256, more than ``4 k`` blocks of 64 rows) such a search takes
    the exact block-maxima prefilter of ``ops/prefilter.py`` instead, inside
    the span ``search.prefilter``: the same top-k without writing the
    scores, and with a launch's maxima and candidates within the same
    budget. With ``item_scale`` (from ``quantize_corpus``) the
    corpus is int8: the queries are quantized per row and scored in exact
    integers (``_int8_scores``); a scalar scale, and the queries' per-row
    scales, multiply the final ``[B, k]`` values only, while a ``[N]`` scale
    multiplies the scores before the top-k. Rows at index >= ``num_valid``
    (padding) are never scored.

    Returns (scores ``[B, k]`` float32 descending, ids ``[B, k]`` int64).
    """
    n = item_emb.shape[0]
    n_valid = _check(n, k, num_valid)
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target={recall_target} must be in (0, 1]")
    quantized = item_scale is not None
    if quantized:
        if item_emb.dtype != torch.int8:
            raise ValueError("item_scale given but item_emb is not int8")
        if tuple(item_scale.shape) not in ((), (n,)):
            raise ValueError(f"item_scale shape {tuple(item_scale.shape)} must be () or ({n},)")
    elif item_emb.dtype == torch.int8:
        raise ValueError(
            "int8 corpus requires item_scale= (from quantize_corpus): casting float "
            "queries to int8 would zero every score"
        )
    b = query_emb.shape[0]
    dev = item_emb.device
    if b == 0:
        return torch.zeros((0, k), device=dev), torch.zeros((0, k), dtype=torch.long, device=dev)
    if not quantized and prefilter.applies(item_emb, k, n_valid):
        with profiling.span("search.prefilter"):
            return prefilter.topk_prefilter(query_emb, item_emb[:n_valid].contiguous(), k,
                                            n_valid, query_chunk * item_chunk)
    per_row_scale = quantized and item_scale.dim() == 1
    if quantized:
        query_emb, query_scale = _quantize_queries(query_emb)
    chunk = min(query_chunk, b)
    block_rows = (
        n if n * chunk <= query_chunk * item_chunk else _blocked_layout(n, item_chunk, k)[1]
    )
    split_tail = quantized and item_emb.shape[1] % 8 == 0
    out_vals, out_ids = [], []
    with float32_products():
        for start in range(0, b, chunk):
            q = query_emb[start : start + chunk]
            top = None
            for lo, hi in _slices(n_valid, block_rows, split_tail):
                if quantized:
                    s = _int8_scores(q, item_emb[lo:hi])
                    if per_row_scale:  # per-item scales change the ranking
                        s = s.float() * item_scale[lo:hi]
                else:
                    s = _scores(q, item_emb[lo:hi])
                v, i = torch.topk(s, min(k, hi - lo), dim=1)
                top = (v, i + lo) if top is None else _merge(*top, v, i + lo, k)
            out_vals.append(top[0])
            out_ids.append(top[1])
    vals, ids = torch.cat(out_vals), torch.cat(out_ids)
    if quantized:
        # Deferred monotonic scales: the queries' per-row scale, and the
        # corpus's global scale when it has one.
        row_scale = query_scale[:, None]
        if not per_row_scale:
            row_scale = row_scale * item_scale
        vals = vals.float() * row_scale
    return vals, ids


def _shard_candidates(search, query, shard, k: int, offset: int, num_items: int | None):
    """One shard's candidates for the cross-shard merge: its top-``min(k,
    rows)`` over its real rows (rows at global index >= ``num_items`` are
    padding and never scored; a shard with fewer real rows than that fills
    with -inf), ids offset by ``offset`` to global ones, on the shard's
    device."""
    rows = shard.shape[0]
    local_k = min(k, rows)
    valid = rows if num_items is None else max(0, min(num_items - offset, rows))
    b = query.shape[0]
    vals = torch.full((b, local_k), float("-inf"), device=shard.device)
    idx = torch.zeros((b, local_k), dtype=torch.long, device=shard.device)
    if valid:
        kk = min(local_k, valid)
        vals[:, :kk], idx[:, :kk] = search(query, shard, kk, valid)
    return vals, idx + offset


def _merge_candidates(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """The exact merge: the top-``k`` of every shard's candidates ``[B,
    shards * local_k]`` (the global top-k lies in their union)."""
    out_vals, sel = torch.topk(vals, k, dim=1)
    return out_vals, torch.gather(idx, 1, sel)


def _shard_topk(search, query, shards, k: int, axis, num_items: int | None):
    """The cross-shard search over a corpus row-sharded in equal shards.
    With ``axis`` (a ``parallel.mesh.Axis``) ``shards`` is this rank's
    shard and the candidates are all-gathered along the axis; without, it
    is the list of every shard (each on its own device, which may repeat),
    searched in turn in one process with the queries copied to each shard's
    device, and only each shard's ``[B, k]`` candidates come back to the
    queries' device. ``search(query, shard, kk, valid, s)`` searches shard
    ``s``. One merge for both forms."""
    b = query.shape[0]
    if axis is not None:
        rows = shards.shape[0]
        vals, idx = _shard_candidates(lambda *a: search(*a, axis.index), query, shards, k,
                                      axis.index * rows, num_items)
        local_k = vals.shape[1]
        vals = axis.all_gather(vals).view(axis.size, b, local_k).permute(1, 0, 2)
        idx = axis.all_gather(idx).view(axis.size, b, local_k).permute(1, 0, 2)
        return _merge_candidates(vals.reshape(b, -1), idx.reshape(b, -1), k)
    rows = shards[0].shape[0]
    if any(s.shape[0] != rows for s in shards):
        raise ValueError("the shards of a sharded corpus must have equal rows")
    parts = [_shard_candidates(lambda *a, s=s: search(*a, s), query.to(shard.device), shard,
                               k, s * rows, num_items)
             for s, shard in enumerate(shards)]
    vals = torch.cat([v.to(query.device) for v, _ in parts], dim=1)
    idx = torch.cat([i.to(query.device) for _, i in parts], dim=1)
    return _merge_candidates(vals, idx, k)


def topk_mips_sharded(
    query_emb: torch.Tensor,
    item_emb_shard,
    k: int,
    *,
    axis=None,
    chunk_size: int | None = None,
    num_items: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over a corpus row-sharded in equal shards (JAX
    ``topk_mips_sharded``): each shard is searched (the two-pass search for
    shards of more than ``4 k`` blocks of 64, the plain scan below) and the
    per-shard candidates merge exactly, since the global top-k lies in the
    union of the per-shard top-ks. ``axis``: a ``parallel.mesh.Axis``, every
    rank of which calls with the same queries and its own shard; None: the
    one-process form, ``item_emb_shard`` the list of every shard, on
    devices that may differ from the queries'. ``num_items``: the real
    corpus size; shard rows past it are padding. Returns the global
    ``(scores, ids)`` on the queries' device (on every rank)."""
    if chunk_size is None:
        chunk_size = exact_scan_chunk(query_emb.shape[0])
    block = 64

    def search(q, shard, kk, valid, _s):
        if shard.shape[0] > 4 * kk * block and chunk_size >= block:
            return topk_mips_twopass(q, shard, kk, chunk_size=chunk_size // block * block,
                                     block=block, num_valid=valid)
        return topk_mips(q, shard, kk, chunk_size=chunk_size, num_valid=valid)

    return _shard_topk(search, query_emb, item_emb_shard, k, axis, num_items)


def topk_mips_approx_sharded(
    query_emb: torch.Tensor,
    item_emb_shard,
    k: int,
    *,
    axis=None,
    recall_target: float = 0.95,
    query_chunk: int = 256,
    item_chunk: int = 1 << 21,
    num_items: int | None = None,
    item_scale_shard=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``topk_mips_approx`` on each shard of a row-sharded corpus, merged as
    ``topk_mips_sharded`` merges, in either form (JAX
    ``topk_mips_approx_sharded``): the only difference from the exact
    search is the corpus's resident precision. ``item_scale_shard``: the
    int8 corpus's scales, a 0-d tensor (the global scale, replicated) or
    the per-row scales of each shard (this rank's ``[rows]`` slice with
    ``axis``; the list of every shard's without)."""

    def scale_of(s):
        if item_scale_shard is None or isinstance(item_scale_shard, torch.Tensor):
            return item_scale_shard
        return item_scale_shard[s]

    def search(q, shard, kk, valid, s):
        scale = scale_of(s)
        return topk_mips_approx(q, shard, kk, recall_target=recall_target,
                                query_chunk=query_chunk, item_chunk=item_chunk,
                                num_valid=valid,
                                item_scale=None if scale is None else scale.to(shard.device))

    return _shard_topk(search, query_emb, item_emb_shard, k, axis, num_items)

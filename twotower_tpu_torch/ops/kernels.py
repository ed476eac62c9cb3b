"""Fused in-batch sampled-softmax loss: CUDA kernels for Hopper and their
plain PyTorch versions.

Counterpart of ``twotower_tpu/ops/pallas_kernels.py``. Three kernels
replace the two TPU kernels:

- ``fused_fwd``    <- ``_fwd_call``: per-row ``loss, lse, correct, pos``
  (``ops/csrc/fused_loss.cu``);
- ``fused_bwd_du`` <- ``_bwd_call`` (dU): row-parallel ``dU = dS . V``;
- ``fused_bwd_dv`` <- ``_bwd_call`` (dV): column-parallel ``dV = dS^T . U``
  (both ``ops/csrc/fused_loss_bwd.cu``).

The TPU kernel accumulated dV across its sequential grid; GPU blocks run in
parallel, so dV has its own kernel that recomputes S from the saved ``lse``
(deterministic, no atomics). Each wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel or raises. Each
counts its launches in ``<wrapper>.launches`` (``build.counted``, with the
search's wrappers: one set of counts, reset together by
``build.reset_launch_counts``).

Products keep float32 accuracy, as the JAX wrapper casts U and V to
float32 and the reference holds the loss to rtol 1e-4: every product of the
three kernels is three TF32 tensor-core passes (``hi.hi + hi.lo + lo.hi``,
operands split as ``precision.tf32_split_plain`` does). Each kernel cuts
its streamed rows into slices that fill the card and merges the slices in a
fixed order (``fwd_merge_plain`` is the forward's merge), so two launches
give the same bits.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

from twotower_tpu_torch.ops import build
from twotower_tpu_torch.ops.losses import NEG_INF, weighted_mean_metrics

_INT32_MAX = 2**31 - 1


def supported_block(rows: int, cols: int, dim: int) -> bool:
    """Kernel coverage for a ``[rows, cols]`` score block of depth ``dim``.

    The kernels mask ragged edges in every dimension and keep no ``B x B``
    or ``B x D`` state on chip (they walk depth in chunks of 128 with a
    fixed 214 KB or less of shared memory a block), so the only limits are
    the 32-bit row/column indices and the grid.
    """
    return 1 <= rows <= cols <= _INT32_MAX and 1 <= dim <= _INT32_MAX // 2


def supported_for(batch: int, dim: int) -> bool:
    """Whether the kernels cover a square single-device batch."""
    return supported_block(batch, batch, dim)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _scores_plain(u, v, ids, cols, row_offset: int, inv_temp: float):
    rows, batch = u.shape[0], v.shape[0]
    s = (u @ v.T) * inv_temp - cols[None, :]
    grow = row_offset + torch.arange(rows, device=u.device)
    diag = torch.arange(batch, device=u.device)[None, :] == grow[:, None]
    masked = (ids[None, :] == ids[grow][:, None]) & ~diag
    return torch.where(masked, NEG_INF, s), diag, masked


def fwd_plain(u, v, ids, cols, row_offset: int, inv_temp: float):
    """Plain version of ``fused_fwd``: ``(loss, lse, correct, pos)``, each ``[R]``."""
    s, diag, _ = _scores_plain(u, v, ids, cols, row_offset, inv_temp)
    m = s.max(dim=1).values
    lse = m + torch.log(torch.exp(s - m[:, None]).sum(dim=1))
    pos = torch.where(diag, s, 0.0).sum(dim=1)
    return lse - pos, lse, (pos >= m).float(), pos


def fwd_merge_plain(m, l, pos):
    """Plain version of the forward's merge pass: from per-slice row
    statistics ``[slices, R]`` (row max ``m`` over the slice's columns,
    ``l = sum exp(S - m)`` over them, and the diagonal score ``pos``, 0 in
    slices without it) to ``(loss, lse, correct, pos)``, each ``[R]``. Only
    the tests use it."""
    m_all = m.max(dim=0).values
    lse = m_all + torch.log((l * torch.exp(m - m_all[None, :])).sum(dim=0))
    pos = pos.sum(dim=0)
    return lse - pos, lse, (pos >= m_all).float(), pos


def _ds_plain(u, v, ids, cols, row_offset, lse, g, inv_temp):
    s, diag, masked = _scores_plain(u, v, ids, cols, row_offset, inv_temp)
    p = torch.where(masked, 0.0, torch.exp(s - lse[:, None]))
    return (p - diag.float()) * g[:, None] * inv_temp


def bwd_du_plain(u, v, ids, cols, row_offset, lse, g, inv_temp):
    """Plain version of ``fused_bwd_du``: ``dS . V``, ``[R, D]``."""
    return _ds_plain(u, v, ids, cols, row_offset, lse, g, inv_temp) @ v


def bwd_dv_plain(u, v, ids, cols, row_offset, lse, g, inv_temp):
    """Plain version of ``fused_bwd_dv``: ``dS^T . U``, ``[B, D]``."""
    return _ds_plain(u, v, ids, cols, row_offset, lse, g, inv_temp).T @ u


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


@cache
def _fwd_lib() -> ctypes.CDLL:
    lib = build.load("fused_loss.cu")
    lib.tt_fused_loss_fwd.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P]
    lib.tt_fused_loss_fwd.restype = ctypes.c_int
    lib.tt_fused_loss_fwd_scratch.argtypes = [_I, _I, _I]
    lib.tt_fused_loss_fwd_scratch.restype = ctypes.c_longlong
    return lib


@cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("fused_loss_bwd.cu")
    for fn in (lib.tt_fused_loss_bwd_du, lib.tt_fused_loss_bwd_dv):
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P]
        fn.restype = ctypes.c_int
    lib.tt_fused_loss_bwd_scratch.argtypes = [_I, _I, _I]
    lib.tt_fused_loss_bwd_scratch.restype = ctypes.c_longlong
    return lib


@cache
def _scratch_floats(lib, query: str, own_rows: int, streamed_rows: int, dim: int,
                    device_index: int) -> int:
    """Float32 scratch a kernel takes on a CUDA device for the partial results
    of the slices it cuts its streamed rows into (the C entry ``query`` of
    the library ``lib()`` answers; 0 for one slice)."""
    with torch.cuda.device(device_index):
        n = getattr(lib(), query)(own_rows, streamed_rows, dim)
    if n < 0:
        raise RuntimeError(f"{query}: scratch size query failed: CUDA error {-n}")
    return n


def _check_coverage(rows: int, batch: int, dim: int, row_offset: int) -> None:
    if not supported_block(rows, batch, dim) or not 0 <= row_offset <= batch - rows:
        raise ValueError(
            f"fused loss kernel does not cover rows={rows}, cols={batch}, "
            f"dim={dim}, row_offset={row_offset}"
        )


def _check_cuda(u, v, ids, cols, row_offset, lse=None, g=None) -> tuple[int, int, int]:
    rows, dim = u.shape
    batch = v.shape[0]
    _check_coverage(rows, batch, dim, row_offset)
    for name, t, dtype, shape in (
        ("u", u, torch.float32, (rows, dim)),
        ("v", v, torch.float32, (batch, dim)),
        ("ids", ids, torch.int32, (batch,)),
        ("cols", cols, torch.float32, (batch,)),
        ("lse", lse, torch.float32, (rows,)),
        ("g", g, torch.float32, (rows,)),
    ):
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"fused loss kernel: {name} must be a contiguous {dtype} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    return rows, batch, dim


@build.counted
def fused_fwd(u, v, ids, cols, row_offset: int, inv_temp: float):
    """``(loss, lse, correct, pos)`` for the rows of ``u`` at ``row_offset``
    against all rows of ``v``: the forward kernel on CUDA tensors, its plain
    version on CPU tensors."""
    if build.on_cpu("fused loss", u, v, ids, cols):
        return fwd_plain(u, v, ids, cols, row_offset, inv_temp)
    rows, batch, dim = _check_cuda(u, v, ids, cols, row_offset)
    # The kernel cuts the columns into slices; their per-row statistics go
    # to scratch (after the four outputs, in one allocation) and are merged
    # in a fixed order.
    n = _scratch_floats(_fwd_lib, "tt_fused_loss_fwd_scratch", rows, batch, dim, u.device.index)
    out = torch.empty(4 * rows + n, dtype=torch.float32, device=u.device)
    loss, lse, correct, pos = out[: 4 * rows].view(4, rows).unbind(0)
    rc = _fwd_lib().tt_fused_loss_fwd(
        u.data_ptr(), v.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        rows, batch, dim, row_offset, inv_temp,
        loss.data_ptr(), lse.data_ptr(), correct.data_ptr(), pos.data_ptr(),
        out.data_ptr() + 16 * rows if n else None, build.stream(u),
    )
    build.raise_on(rc, "fused_loss_fwd_kernel")
    build.count(fused_fwd)
    return loss, lse, correct, pos


def _bwd(fn_name: str, out_rows_of_v: bool, u, v, ids, cols, row_offset, lse, g, inv_temp):
    rows, batch, dim = _check_cuda(u, v, ids, cols, row_offset, lse, g)
    own, streamed = (batch, rows) if out_rows_of_v else (rows, batch)
    out = torch.empty((own, dim), dtype=torch.float32, device=u.device)
    # The kernel cuts the streamed rows into slices; their partial sums go
    # to scratch and are added in a fixed order.
    n = _scratch_floats(_bwd_lib, "tt_fused_loss_bwd_scratch", own, streamed, dim,
                        u.device.index)
    scratch = torch.empty(n, dtype=torch.float32, device=u.device) if n else None
    rc = getattr(_bwd_lib(), fn_name)(
        u.data_ptr(), v.data_ptr(), ids.data_ptr(), cols.data_ptr(),
        lse.data_ptr(), g.data_ptr(), rows, batch, dim, row_offset, inv_temp,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), build.stream(u),
    )
    build.raise_on(rc, fn_name)
    return out


@build.counted
def fused_bwd_du(u, v, ids, cols, row_offset: int, lse, g, inv_temp: float):
    """``dU = dS . V`` (``[R, D]``): the row-parallel kernel on CUDA tensors,
    its plain version on CPU tensors."""
    if build.on_cpu("fused loss", u, v, ids, cols, lse, g):
        return bwd_du_plain(u, v, ids, cols, row_offset, lse, g, inv_temp)
    du = _bwd("tt_fused_loss_bwd_du", False, u, v, ids, cols, row_offset, lse, g, inv_temp)
    build.count(fused_bwd_du)
    return du


@build.counted
def fused_bwd_dv(u, v, ids, cols, row_offset: int, lse, g, inv_temp: float):
    """``dV = dS^T . U`` (``[B, D]``): the column-parallel kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if build.on_cpu("fused loss", u, v, ids, cols, lse, g):
        return bwd_dv_plain(u, v, ids, cols, row_offset, lse, g, inv_temp)
    dv = _bwd("tt_fused_loss_bwd_dv", True, u, v, ids, cols, row_offset, lse, g, inv_temp)
    build.count(fused_bwd_dv)
    return dv


WRAPPERS = (fused_fwd, fused_bwd_du, fused_bwd_dv)  # the loss's: one launch each a step


# ---------------------------------------------------------------------------
# Autograd op and public surface
# ---------------------------------------------------------------------------


class _FusedPerExampleLoss(torch.autograd.Function):
    """Per-row loss with the kernels' backward (the JAX custom VJP).
    Temperature and the row offset are non-differentiable constants;
    ``correct`` and ``pos`` are metric outputs with zero cotangents."""

    @staticmethod
    def forward(ctx, u, v, ids, cols, row_offset: int, temperature: float):
        inv_temp = 1.0 / temperature
        loss, lse, correct, pos = fused_fwd(u, v, ids, cols, row_offset, inv_temp)
        ctx.save_for_backward(u, v, ids, cols, lse)
        ctx.row_offset = row_offset
        ctx.inv_temp = inv_temp
        ctx.mark_non_differentiable(correct, pos)
        return loss, correct, pos

    @staticmethod
    def backward(ctx, g, _g_correct, _g_pos):
        u, v, ids, cols, lse = ctx.saved_tensors
        g = g.float().contiguous()
        args = (u, v, ids, cols, ctx.row_offset, lse, g, ctx.inv_temp)
        du = fused_bwd_du(*args) if ctx.needs_input_grad[0] else None
        dv = fused_bwd_dv(*args) if ctx.needs_input_grad[1] else None
        return du, dv, None, None, None, None


def logq_cols(
    item_idx: torch.Tensor,
    log_q: torch.Tensor | None,
    weights_all: torch.Tensor | None,
) -> torch.Tensor:
    """Per-column log-Q vector with zero-weight padding columns folded in as
    a +1e9 shift (so they mask to ~-1e9 after subtraction — padding columns
    must not act as in-batch negatives)."""
    if log_q is not None:
        cols = log_q[item_idx.long()].float()
    else:
        cols = torch.zeros(item_idx.shape[0], device=item_idx.device)
    if weights_all is not None:
        cols = cols + torch.where(weights_all == 0.0, -NEG_INF, 0.0)
    return cols.contiguous()


def fused_in_batch_softmax_block(
    user_emb: torch.Tensor,
    item_emb_all: torch.Tensor,
    item_idx_all: torch.Tensor,
    row_offset: int,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights_all: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused twin of ``ops.losses.in_batch_softmax_block``: per-row
    ``(per_example, correct, raw_diag)`` for the rows of ``user_emb`` at
    ``row_offset`` against all item columns."""
    rows, dim = user_emb.shape
    batch = item_emb_all.shape[0]
    row_offset = int(row_offset)
    _check_coverage(rows, batch, dim, row_offset)
    u = user_emb.float().contiguous()
    v = item_emb_all.float().contiguous()
    ids = item_idx_all.to(torch.int32).contiguous()
    cols = logq_cols(ids, log_q, weights_all)
    per_example, correct, pos = _FusedPerExampleLoss.apply(
        u, v, ids, cols, row_offset, float(temperature)
    )
    # pos = raw/temp - logq_col  =>  raw = (pos + logq_col) * temp (exact,
    # including the folded padding shift).
    raw_diag = (pos + cols[row_offset : row_offset + rows]) * temperature
    return per_example, correct, raw_diag.detach()


def fused_in_batch_softmax_loss(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    item_idx: torch.Tensor,
    *,
    temperature: float = 0.1,
    log_q: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Fused drop-in for ``ops.losses.in_batch_softmax_loss`` (same contract
    and metrics); ``ops/dispatch.py`` routes CUDA tensors here."""
    per_example, correct, raw_diag = fused_in_batch_softmax_block(
        user_emb,
        item_emb,
        item_idx,
        0,
        temperature=temperature,
        log_q=log_q,
        weights_all=weights,
    )
    return weighted_mean_metrics(per_example, correct, raw_diag, weights)

"""Block attention over packed streams, the core of the sequence tower's MLA
(``models/seq_tower.py``): CUDA kernels for Hopper and their plain PyTorch
versions.

A stream is ``S`` slots of users' windows laid end to end; ``pos[s]`` is a
slot's place in its window, which holds at most ``window`` slots. Query
``q`` sees key ``k`` iff ``k <= q``, ``k >= q - pos[q]`` and ``k`` lies in
``q``'s block of ``window`` slots or the one before (``first_keys``). Per
head, with ``q = [q_nope | q_pe]`` and ``k = [k_nope | k_pe]``, where
``k_pe`` ``[S, dr]`` is MLA's one RoPE key for every head::

    out = softmax(scale q k^T, masked) v        [S, h dv]

The inputs are the projections' outputs as they lie: ``q`` ``[S, h, dn +
dr]`` (RoPE applied to ``q_pe``), ``kv`` ``[S, h, dn + dv]`` (``k_nope |
v``, kv_b's output) and ``k_pe``; the gradients come back in the same
layouts. Three wrappers, each counting its launches (``build.counted``):
``attention_fwd`` (``out`` and the log-sum-exp ``lse`` ``[h, S]``),
``attention_dq`` (``dq``, and ``D = rowsum(dO o O)`` for the next) and
``attention_dkv`` (``dkv`` and ``dk_pe``, its heads' shares summed in a
fixed order). ``stream_attention`` is the autograd function over them.

Precision: the scores accumulate in float32 from the operands as given
(bfloat16 on the card) and stay float32 through the mask and the softmax;
``P`` is rounded to the operands' dtype for ``P v``, as ``dS = P o (dP -
D)`` is for ``dS k`` and ``dS^T q``; outputs are in the operands' dtype,
``lse`` and ``D`` float32. The plain versions (``*_plain``) compute the same
in float32 over blocks of ``window`` queries against ``2 window`` keys.

Each wrapper takes its plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel (``ops/csrc/stream_attention.cu``, built at
first use) or raises: the kernels take bfloat16 at the instantiated
``(window, dn, dr, dv)`` alone (``SHAPES``), and no caller on the card runs
the tower in another dtype.
"""

from __future__ import annotations

import ctypes
from functools import cache

import torch

from twotower_tpu_torch.ops import build

# (window, dn, dr, dv) the kernels are instantiated for: DeepSeek-V2-Lite's
# MLA at windows of 64 (configs/torch/seq_dsv2lite_1chip.yaml), and the
# card's test tower (tests/test_torch_seq_cuda.py).
SHAPES = ((64, 128, 64, 128), (16, 32, 16, 32))


def first_keys(pos: torch.Tensor, window: int) -> torch.Tensor:
    """``[S]`` int64: each query's first key slot (its last is itself)."""
    q = torch.arange(pos.shape[0], device=pos.device)
    return torch.maximum(q - pos.long(), (q // window - 1) * window).clamp(min=0)


def _widths(q, kv, k_pe) -> tuple[int, int, int, int, int]:
    n, h, dqk = q.shape
    dr = k_pe.shape[1]
    dn = dqk - dr
    return n, h, dn, dr, kv.shape[2] - dn


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the kernels are checked against)
# ---------------------------------------------------------------------------


def _blocks(t: torch.Tensor, w: int) -> torch.Tensor:
    """``[S, ...]`` -> ``[S / w, 2 w, ...]``: each block after the one before
    it (zeros before the stream's start)."""
    t = t.reshape(t.shape[0] // w, w, *t.shape[1:])
    return torch.cat([torch.cat([torch.zeros_like(t[:1]), t[:-1]]), t], dim=1)


def _unblocks(t: torch.Tensor, w: int) -> torch.Tensor:
    """The adjoint of ``_blocks``: ``[S / w, 2 w, ...]`` -> ``[S, ...]``,
    each slot's two rows summed."""
    out = t[:, w:].clone()
    out[:-1] += t[1:, :w]
    return out.reshape(-1, *t.shape[2:])


class _Plain:
    """The blocks of one call, in float32: ``q`` ``[S / W, h, W, dn + dr]``,
    ``k`` and ``v`` ``[S / W, h, 2 W, .]``, the mask ``[S / W, 1, W, 2 W]``
    and the scaled scores, masked with -inf."""

    def __init__(self, q, kv, k_pe, pos, window: int, scale: float):
        n, h, dn, dr, dv = _widths(q, kv, k_pe)
        if n % window:
            raise ValueError(f"a stream of {n} slots is not a multiple of window={window}")
        self.w, self.n, self.h, self.dn = window, n, h, dn
        self.dtype, self.scale = q.dtype, scale
        nb = n // window
        self.q = q.float().reshape(nb, window, h, dn + dr).transpose(1, 2)
        k = torch.cat([kv[..., :dn].float(), k_pe.float()[:, None].expand(n, h, dr)], dim=-1)
        self.k = _blocks(k, window).transpose(1, 2)
        self.v = _blocks(kv[..., dn:].float(), window).transpose(1, 2)
        slot = torch.arange(n, device=q.device).view(nb, window, 1)
        key = (torch.arange(nb, device=q.device)[:, None, None] - 1) * window + torch.arange(
            2 * window, device=q.device)
        first = first_keys(pos, window).view(nb, window, 1)
        self.mask = ((key <= slot) & (key >= first))[:, None]
        s = self.q @ self.k.transpose(-1, -2) * scale
        self.scores = s.masked_fill(~self.mask, float("-inf"))

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """``[S, h d]`` -> ``[S / W, h, W, d]`` in float32."""
        return t.float().reshape(self.n // self.w, self.w, self.h, -1).transpose(1, 2)

    def probs(self, lse: torch.Tensor) -> torch.Tensor:
        """``P`` from the forward's ``lse`` ``[h, S]`` (0 where masked)."""
        lse = lse.reshape(self.h, self.n // self.w, self.w).transpose(0, 1)[..., None]
        return torch.exp(self.scores - lse)

    def ds(self, lse, delta, dout) -> tuple[torch.Tensor, torch.Tensor]:
        """``(P, dS)`` with ``dS`` scaled, both float32."""
        p = self.probs(lse)
        dp = self.rows(dout) @ self.v.transpose(-1, -2)
        d = delta.reshape(self.h, self.n // self.w, self.w).transpose(0, 1)[..., None]
        return p, p * (dp - d) * self.scale

    def rounded(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` rounded to the operands' dtype, as a kernel's A operand is."""
        return t.to(self.dtype).float()


def fwd_plain(q, kv, k_pe, pos, window: int, scale: float):
    """Plain version of ``attention_fwd``: ``(out [S, h dv], lse [h, S])``."""
    b = _Plain(q, kv, k_pe, pos, window, scale)
    lse = torch.logsumexp(b.scores, dim=-1)
    out = b.rounded(torch.exp(b.scores - lse[..., None])) @ b.v
    out = out.transpose(1, 2).reshape(b.n, -1).to(q.dtype)
    return out, lse.transpose(0, 1).reshape(b.h, b.n)


def dq_plain(q, kv, k_pe, pos, window: int, scale: float, out, lse, dout):
    """Plain version of ``attention_dq``: ``(dq [S, h, dn + dr], D [h, S])``."""
    b = _Plain(q, kv, k_pe, pos, window, scale)
    delta = (b.rows(dout) * b.rows(out)).sum(-1)
    _, ds = b.ds(lse, delta.transpose(0, 1).reshape(b.h, b.n), dout)
    dq = (b.rounded(ds) @ b.k).transpose(1, 2).reshape(q.shape).to(q.dtype)
    return dq, delta.transpose(0, 1).reshape(b.h, b.n)


def dkv_plain(q, kv, k_pe, pos, window: int, scale: float, lse, delta, dout):
    """Plain version of ``attention_dkv``: ``(dkv [S, h, dn + dv], dk_pe [S,
    dr])``."""
    b = _Plain(q, kv, k_pe, pos, window, scale)
    p, ds = b.ds(lse, delta, dout)
    dv = _unblocks((b.rounded(p).transpose(-1, -2) @ b.rows(dout)).transpose(1, 2), window)
    dk = _unblocks((b.rounded(ds).transpose(-1, -2) @ b.q).transpose(1, 2), window)
    dkv = torch.cat([dk[..., :b.dn], dv], dim=-1).to(kv.dtype)
    return dkv, dk[..., b.dn:].sum(1).to(k_pe.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    "tt_stream_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "tt_stream_attention_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P,
                               _P],
    "tt_stream_attention_dkv": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P, _P,
                                _P],
}


@cache
def _lib() -> ctypes.CDLL:
    lib = build.load("stream_attention.cu")
    for name, argtypes in _ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def _launch(wrapper, entry: str, q, kv, k_pe, pos, window: int, scale: float, *tensors,
            outs) -> None:
    """Check the inputs, then launch ``entry`` with ``tensors`` (the inputs
    after ``pos``: ``[S, h dv]`` bfloat16 rows, ``out`` and ``dout``, or
    ``[h, S]`` float32 statistics, ``lse`` and ``D``) and ``outs``, counted
    as a launch of ``wrapper``."""
    n, h, dn, dr, dv = _widths(q, kv, k_pe)
    shapes = {torch.bfloat16: (n, h * dv), torch.float32: (h, n)}
    if not (all(t.dtype == torch.bfloat16 for t in (q, kv, k_pe))
            and all(tuple(t.shape) == shapes.get(t.dtype) for t in tensors)
            and q.dim() == kv.dim() == 3 and k_pe.dim() == 2 and kv.shape[:2] == (n, h)
            and k_pe.shape[0] == n and pos.shape == (n,) and pos.dtype == torch.int32
            and (window, dn, dr, dv) in SHAPES
            and all(t.is_contiguous() for t in (q, kv, k_pe, pos, *tensors))
            and all(t.data_ptr() % 16 == 0 for t in (q, kv, k_pe, *tensors))):
        raise ValueError(
            f"stream attention kernel: takes contiguous bfloat16 q [S, h, dn + dr], kv [S, h, "
            f"dn + dv], k_pe [S, dr] and int32 pos [S] at (window, dn, dr, dv) in {SHAPES}; got "
            f"{q.dtype} {tuple(q.shape)}, {kv.dtype} {tuple(kv.shape)}, {k_pe.dtype} "
            f"{tuple(k_pe.shape)}, {pos.dtype} {tuple(pos.shape)}, window {window}, and "
            f"{[(t.dtype, tuple(t.shape)) for t in tensors]} (or an address not 16-byte "
            "aligned)")
    ptrs = [t.data_ptr() for t in (q, kv, k_pe, pos, *tensors)]
    with torch.cuda.device(q.device):
        rc = getattr(_lib(), entry)(*ptrs, n, h, window, dn, dr, dv, scale,
                                    *(t.data_ptr() for t in outs), build.stream(q))
    build.raise_on(rc, entry)
    build.count(wrapper)


@build.counted
def attention_fwd(q, kv, k_pe, pos, window: int, scale: float):
    """``(out [S, h dv], lse [h, S] float32)``: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if build.on_cpu("stream attention", q, kv, k_pe, pos):
        return fwd_plain(q, kv, k_pe, pos, window, scale)
    n, h, _, _, dv = _widths(q, kv, k_pe)
    out = torch.empty((n, h * dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, n), dtype=torch.float32, device=q.device)
    _launch(attention_fwd, "tt_stream_attention_fwd", q, kv, k_pe, pos, window, scale,
            outs=(out, lse))
    return out, lse


@build.counted
def attention_dq(q, kv, k_pe, pos, window: int, scale: float, out, lse, dout):
    """``(dq [S, h, dn + dr], D [h, S] float32)`` from the forward's ``out``
    and ``lse`` and the gradient ``dout`` ``[S, h dv]``."""
    if build.on_cpu("stream attention", q, kv, k_pe, pos, out, lse, dout):
        return dq_plain(q, kv, k_pe, pos, window, scale, out, lse, dout)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _launch(attention_dq, "tt_stream_attention_dq", q, kv, k_pe, pos, window, scale, out, lse,
            dout, outs=(dq, delta))
    return dq, delta


@build.counted
def attention_dkv(q, kv, k_pe, pos, window: int, scale: float, lse, delta, dout):
    """``(dkv [S, h, dn + dv], dk_pe [S, dr])`` from ``lse``, ``attention_dq``'s
    ``D`` and ``dout``; on the card each head's share of ``dk_pe`` in
    float32, summed over the heads by ``torch.sum`` (a fixed order)."""
    if build.on_cpu("stream attention", q, kv, k_pe, pos, lse, delta, dout):
        return dkv_plain(q, kv, k_pe, pos, window, scale, lse, delta, dout)
    n, h, _, dr, _ = _widths(q, kv, k_pe)
    dkv = torch.empty_like(kv)
    dkpe = torch.empty((n, h, dr), dtype=torch.float32, device=q.device)
    _launch(attention_dkv, "tt_stream_attention_dkv", q, kv, k_pe, pos, window, scale, lse,
            delta, dout, outs=(dkv, dkpe))
    return dkv, dkpe.sum(1).to(k_pe.dtype)


WRAPPERS = (attention_fwd, attention_dq, attention_dkv)


class _StreamAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, k_pe, pos, window, scale):
        out, lse = attention_fwd(q, kv, k_pe, pos, window, scale)
        ctx.save_for_backward(q, kv, k_pe, pos, out, lse)
        ctx.window, ctx.scale = window, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, kv, k_pe, pos, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        args = (q, kv, k_pe, pos, ctx.window, ctx.scale)
        dq, delta = attention_dq(*args, out, lse, dout)
        dkv, dk_pe = attention_dkv(*args, lse, delta, dout)
        return dq, dkv, dk_pe, None, None, None


def stream_attention(q: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor, pos: torch.Tensor,
                     window: int, scale: float) -> torch.Tensor:
    """``out`` ``[S, h dv]`` of ``q`` ``[S, h, dn + dr]``, ``kv`` ``[S, h, dn
    + dv]``, ``k_pe`` ``[S, dr]`` and ``pos`` ``[S]``, differentiable in the
    first three."""
    return _StreamAttention.apply(q, kv, k_pe, pos, window, scale)

"""Float32 accuracy of the port's products, decided in one place.

Two ways keep a float32 product at float32 accuracy on the card:

- library products with TF32 off (the JAX exact code asks for
  ``Precision.HIGHEST``): every product runs inside ``float32_products()``,
  which holds the process-wide TF32 switch off while any thread is inside
  and restores the caller's setting after (the switch is
  ``torch.backends.cuda.matmul.fp32_precision`` where PyTorch has it, else
  the legacy ``allow_tf32``; ``matmul_tf32`` reads it);
- three TF32 tensor-core passes of split operands, as the fused loss's and
  the float32 prefilter's kernels take them: ``tf32_split_plain`` is their
  split, which the plain versions and the tests use.
"""

from __future__ import annotations

import contextlib
import threading

import torch

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


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernels' operand split for three TF32 passes: ``hi = rna(x)`` and
    ``lo = rna(x - hi)``, where ``rna`` rounds a float32 to TF32's 10
    mantissa bits, to nearest with ties away from zero, as
    ``cvt.rna.tf32.f32`` does. ``hi.hi + hi.lo + lo.hi`` then keeps float32
    accuracy."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)

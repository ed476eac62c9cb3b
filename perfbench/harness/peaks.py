"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit), and the roofline bound of a piece of work."""

from __future__ import annotations

BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12

# Work that must stay accurate to float32 runs either on the float32 units
# or as three TF32 passes on the tensor cores: the faster of the two.
F32_ACCURATE_FLOPS = max(F32_FLOPS, TF32_FLOPS / 3)

FLOPS_BY_DTYPE = {"float32": F32_ACCURATE_FLOPS, "bfloat16": BF16_FLOPS, "int8": INT8_OPS}


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of the operations at
    ``peak_flops`` and the bytes at the HBM bandwidth."""
    return max(flops / peak_flops, nbytes / HBM_BYTES)

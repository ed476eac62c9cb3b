"""The numeric scheme of the backward kernels, on the CPU: each float32
operand split into ``hi = rna(x)`` and ``lo = rna(x - hi)`` (TF32, round to
nearest with ties away from zero, as ``cvt.rna.tf32.f32``), and each product
taken as ``lo.hi + hi.lo + hi.hi`` with float32 sums (three TF32 passes).

At the shapes ``chip_smoke.py`` checks the kernels at, dU and dV computed
that way stay within the kernels' tolerance (rtol 5e-3, atol 1e-5) of their
float32 plain versions. One TF32 pass does not at the raw-row shapes, where
the logits reach ~100: that is why the kernels take three."""

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu_torch.ops import kernels

TEMP = 0.1
RTOL, ATOL = 5e-3, 1e-5
# batch, dim, rows, row offset, unit-norm rows (chip_smoke.py's CHECK_SHAPES)
SHAPES = [
    (4096, 128, 4096, 0, True),
    (1000, 128, 1000, 0, False),
    (1000, 96, 300, 500, False),
    (4097, 128, 4097, 0, True),
    (1000, 20, 1000, 0, False),
    (600, 30, 600, 0, False),
    (512, 256, 512, 0, True),
]
RAW_SHAPES = [s for s in SHAPES if not s[4]]


def _inputs(batch, dim, rows, off, unit):
    """chip_smoke.py's inputs, from numpy: U rows at ``off`` of the block,
    V, int32 ids with duplicates, log-q columns with 7 zero-weight columns
    folded in, an upstream g, and the plain forward's lse."""
    rng = np.random.default_rng(batch + dim)
    u = rng.normal(size=(rows + off, dim)).astype(np.float32)[off:]
    v = rng.normal(size=(batch, dim)).astype(np.float32)
    if unit:
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    half = max(batch // 2, 1)
    ids = torch.from_numpy(rng.integers(0, half, batch).astype(np.int32))
    log_q = torch.from_numpy(np.log(rng.uniform(1e-4, 1e-2, half)).astype(np.float32))
    w = torch.ones(batch)
    w[-7:] = 0.0
    cols = kernels.logq_cols(ids, log_q, w)
    g = torch.from_numpy((rng.uniform(size=rows) / rows).astype(np.float32))
    u, v = torch.from_numpy(np.ascontiguousarray(u)), torch.from_numpy(v)
    lse = kernels.fwd_plain(u, v, ids, cols, off, 1 / TEMP)[1]
    return u, v, ids, cols, off, lse, g, 1 / TEMP


def _mm(a, b, passes):
    a_hi, a_lo = kernels.tf32_split_plain(a)
    b_hi, b_lo = kernels.tf32_split_plain(b)
    if passes == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _bwd_tf32(u, v, ids, cols, off, lse, g, inv_temp, passes):
    """dU and dV as the kernels compute them: S recomputed, dS formed in
    float32, and both products in ``passes`` TF32 passes."""
    rows, batch = u.shape[0], v.shape[0]
    s = _mm(u, v.T, passes) * inv_temp - cols[None, :]
    grow = off + torch.arange(rows)
    diag = torch.arange(batch)[None, :] == grow[:, None]
    masked = (ids[None, :] == ids[grow][:, None]) & ~diag
    p = torch.where(masked, 0.0, torch.exp(s - lse[:, None]))
    ds = (p - diag.float()) * g[:, None] * inv_temp
    return _mm(ds, v, passes), _mm(ds.T.contiguous(), u, passes)


def _share_of_tolerance(got, ref):
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


def test_split_rounds_to_nearest_ties_away_and_is_exact_to_float32():
    one = 1.0
    x = torch.tensor(
        [one + 2**-11, -(one + 2**-11), one + 2**-12, one + 3 * 2**-11, 3.0, 0.0, -1e-30],
        dtype=torch.float32,
    )
    hi, lo = kernels.tf32_split_plain(x)
    # Ties (half a TF32 ulp, 2^-11 at 1.0) go away from zero; below a half
    # rounds down; 1 + 3 * 2^-11 is a tie between 1 + 2^-10 and 1 + 2^-9.
    expect_hi = [one + 2**-10, -(one + 2**-10), one, one + 2**-9, 3.0, 0.0]
    assert hi[:6].tolist() == expect_hi
    bits = torch.cat([hi, lo]).view(torch.int32)
    assert torch.all(bits & 0x1FFF == 0)  # 10 mantissa bits left
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(size=10_000).astype(np.float32) * 10.0 ** rng.integers(-3, 4))
    y_hi, y_lo = kernels.tf32_split_plain(y)
    assert torch.all(y_hi.abs() <= y.abs() * (1 + 2**-11))
    assert torch.all((y_hi + y_lo - y).abs() <= y.abs() * 2**-21)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B{}-D{}-R{}-off{}-{}".format(
    *s[:4], "unit" if s[4] else "raw"))
def test_three_tf32_passes_keep_the_kernel_tolerance(shape):
    args = _inputs(*shape)
    du, dv = _bwd_tf32(*args, passes=3)
    torch.testing.assert_close(du, kernels.bwd_du_plain(*args), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dv, kernels.bwd_dv_plain(*args), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", RAW_SHAPES, ids=lambda s: "B{}-D{}-R{}-off{}".format(*s[:4]))
def test_one_tf32_pass_misses_the_tolerance_at_raw_rows(shape):
    args = _inputs(*shape)
    du, dv = _bwd_tf32(*args, passes=1)
    assert _share_of_tolerance(du, kernels.bwd_du_plain(*args)) > 1.0
    assert _share_of_tolerance(dv, kernels.bwd_dv_plain(*args)) > 1.0

"""The numeric scheme of the forward kernel, on the CPU: S = U . V^T taken
as ``lo.hi + hi.lo + hi.hi`` in TF32 (operands split as the kernel splits
them, ``precision.tf32_split_plain``), then the forward's masking and
logsumexp; and its merge pass, which turns the per-slice row statistics of
the column slices into the row's outputs.

At the shapes ``chip_smoke.py`` checks the kernels at, three TF32 passes keep
the forward's tolerance (rtol 1e-4, atol 1e-4) against its float32 plain
version; one pass misses it at every one of them, which is why the kernel
takes three. ``fwd_merge_plain`` applied to the statistics of column slices
that do not divide the batch evenly gives the whole row's outputs."""

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_tf32_split import SHAPES, _inputs, _mm
from twotower_tpu_torch.ops import kernels
from twotower_tpu_torch.ops.losses import NEG_INF

RTOL, ATOL = 1e-4, 1e-4
TILE = 32  # columns a tile of the forward kernel


def _shape_id(s):
    return "B{}-D{}-R{}-off{}-{}".format(*s[:4], "unit" if s[4] else "raw")


def _scores(u, v, ids, cols, off, inv_temp, passes):
    """S as the kernel forms it, in ``passes`` TF32 passes, with the diagonal."""
    rows, batch = u.shape[0], v.shape[0]
    s = _mm(u, v.T, passes) * inv_temp - cols[None, :]
    grow = off + torch.arange(rows)
    diag = torch.arange(batch)[None, :] == grow[:, None]
    masked = (ids[None, :] == ids[grow][:, None]) & ~diag
    return torch.where(masked, NEG_INF, s), diag


def _slice_stats(s, diag, bounds):
    """Per-slice row max, exp-sum relative to it, and diagonal score,
    ``[slices, R]`` each, over the column ranges ``bounds``."""
    m, l, pos = [], [], []
    for c0, c1 in bounds:
        part = s[:, c0:c1]
        m_s = part.max(dim=1).values
        m.append(m_s)
        l.append(torch.exp(part - m_s[:, None]).sum(dim=1))
        pos.append(torch.where(diag[:, c0:c1], part, 0.0).sum(dim=1))
    return torch.stack(m), torch.stack(l), torch.stack(pos)


def _kernel_slices(batch, slices):
    """Column ranges of ``slices`` slices of whole tiles, as the kernel cuts
    them: the last one ragged."""
    n_tiles = -(-batch // TILE)
    per = -(-n_tiles // slices)
    return [(t * TILE, min((t + per) * TILE, batch)) for t in range(0, n_tiles, per)]


def _live(args):
    """Rows outside the 7 zero-weight columns, whose pos and loss sit near
    -1e9 / +1e9 by design."""
    u, v, _, _, off = args[:5]
    return off + torch.arange(u.shape[0]) < v.shape[0] - 7


def _fwd_tf32(args, passes):
    u, v, ids, cols, off, _, _, inv_temp = args
    s, diag = _scores(u, v, ids, cols, off, inv_temp, passes)
    return kernels.fwd_merge_plain(*_slice_stats(s, diag, [(0, v.shape[0])]))


def _share_of_tolerance(got, ref):
    return float(((got - ref).abs() / (ATOL + RTOL * ref.abs())).max())


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_three_tf32_passes_keep_the_forward_tolerance(shape):
    args = _inputs(*shape)
    u, v, ids, cols, off, _, _, inv_temp = args
    live = _live(args)
    got = _fwd_tf32(args, passes=3)
    ref = kernels.fwd_plain(u, v, ids, cols, off, inv_temp)
    for name, a, b in zip(("loss", "lse", "pos"), (got[0], got[1], got[3]),
                          (ref[0], ref[1], ref[3])):
        torch.testing.assert_close(a[live], b[live], rtol=RTOL, atol=ATOL, msg=name)
    assert torch.equal(got[2][live], ref[2][live])  # correct


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_one_tf32_pass_misses_the_forward_tolerance(shape):
    args = _inputs(*shape)
    u, v, ids, cols, off, _, _, inv_temp = args
    live = _live(args)
    got = _fwd_tf32(args, passes=1)
    ref = kernels.fwd_plain(u, v, ids, cols, off, inv_temp)
    worst = max(_share_of_tolerance(got[i][live], ref[i][live]) for i in (0, 1, 3))
    assert worst > 1.0


@pytest.mark.parametrize(
    "batch,dim,rows,off,slices",
    [(4097, 128, 4097, 0, 4), (1000, 96, 300, 500, 3), (600, 30, 600, 0, 7),
     (1000, 20, 1000, 0, 1)],
)
def test_merge_of_column_slices_gives_the_whole_row(batch, dim, rows, off, slices):
    args = _inputs(batch, dim, rows, off, True)
    u, v, ids, cols, off, _, _, inv_temp = args
    bounds = _kernel_slices(batch, slices)
    assert len(bounds) == slices
    s, diag, _ = kernels._scores_plain(u, v, ids, cols, off, inv_temp)
    m, l, pos = _slice_stats(s, diag, bounds)
    # The diagonal lies in one slice of each row; others hold none of it.
    assert torch.equal((pos != 0).sum(dim=0), torch.ones(rows, dtype=torch.long))
    got = kernels.fwd_merge_plain(m, l, pos)
    ref = kernels.fwd_plain(u, v, ids, cols, off, inv_temp)
    if slices == 1:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        return
    live = _live(args)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-6)  # lse
    torch.testing.assert_close(got[0][live], ref[0][live], rtol=1e-6, atol=1e-6)  # loss
    assert torch.equal(got[2], ref[2])  # correct
    assert torch.equal(got[3], ref[3])  # pos: one slice holds it, the others add 0


def test_merge_skips_slices_without_a_row_maximum():
    """A slice whose every column is masked for a row (max -1e9) adds
    nothing measurable; one whose max is far above the others sets lse."""
    m = torch.tensor([[NEG_INF, 3.0], [2.0, NEG_INF], [1.0, 50.0]])
    l = torch.tensor([[5.0, 1.0], [2.0, 4.0], [1.5, 1.0]])
    pos = torch.tensor([[0.0, 0.0], [2.0, 0.0], [0.0, 50.0]])
    loss, lse, correct, p = kernels.fwd_merge_plain(m, l, pos)
    expect = np.logaddexp(2.0 + np.log(2.0), 1.0 + np.log(1.5))
    assert lse[0].item() == pytest.approx(expect, rel=1e-6)
    assert lse[1].item() == pytest.approx(50.0, rel=1e-6)
    assert correct.tolist() == [1.0, 1.0]
    assert p.tolist() == [2.0, 50.0]
    assert loss[0].item() == pytest.approx(expect - 2.0, rel=1e-6)

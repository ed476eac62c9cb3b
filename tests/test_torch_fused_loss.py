"""The port's fused in-batch loss against the JAX package.

Same numpy inputs through the JAX XLA reference (``ops/losses.py``), the
JAX Pallas kernel (interpret mode off-TPU, as tests/test_pallas.py runs
it) and the port's two CPU paths: the plain loss (``ops/losses.py``) and
the fused op (``ops/kernels.py``: the autograd op whose forward/backward
wrappers take their kernels' plain versions on CPU tensors). Forward,
metrics, dU and dV are compared with test_pallas.py's tolerances: loss rtol
1e-4; gradients rtol 5e-3 with atol 1e-5 (square) or 5e-4 (block, where
f32 accumulation-order noise over the 512-wide lse enters).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotower_tpu.ops import losses as jax_losses
from twotower_tpu.ops import pallas_kernels
from twotower_tpu_torch.ops import kernels, losses
from twotower_tpu_torch.ops.dispatch import (
    in_batch_softmax_block_auto,
    in_batch_softmax_loss_auto,
)
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)

JAX_LOSS = {
    "xla": jax_losses.in_batch_softmax_loss,
    "pallas": pallas_kernels.fused_in_batch_softmax_loss,
}
JAX_BLOCK = {
    "xla": jax_losses.in_batch_softmax_block,
    "pallas": pallas_kernels.fused_in_batch_softmax_block,
}
PORT_LOSS = {
    "plain": losses.in_batch_softmax_loss,
    "fused": kernels.fused_in_batch_softmax_loss,
}
PORT_BLOCK = {
    "plain": losses.in_batch_softmax_block,
    "fused": kernels.fused_in_batch_softmax_block,
}


def _inputs(seed, batch, dim, num_items=1000, dup=False):
    """test_pallas.py's inputs: unique ids (or three rows sharing one),
    log q over the catalog, the last three rows zero-weight padding."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(batch, dim)).astype(np.float32)
    v = rng.normal(size=(batch, dim)).astype(np.float32)
    idx = rng.choice(num_items, size=batch, replace=False).astype(np.int32)
    if dup:
        idx[1] = idx[0]
        idx[7] = idx[0]
    log_q = np.log(rng.uniform(0.001, 0.1, size=num_items)).astype(np.float32)
    w = np.ones(batch, np.float32)
    w[-3:] = 0.0
    return u, v, idx, log_q, w


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = {
    # name: (dup, use log_q + weights, temperature)
    "dup_ids": (True, True, 0.1),
    "unique_ids": (False, True, 0.1),
    "no_logq": (False, False, 0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("port", sorted(PORT_LOSS))
@pytest.mark.parametrize("ref", sorted(JAX_LOSS))
def test_loss_matches_jax(ref, port, case):
    dup, with_lq, temp = CASES[case]
    u, v, idx, log_q, w = _inputs(1, 256, 128, dup=dup)
    if not with_lq:
        log_q = w = None

    def jax_fn(u, v):
        return JAX_LOSS[ref](
            u, v, _j(idx), temperature=temp, log_q=_j(log_q), weights=_j(w)
        )

    (j_loss, j_m), (j_du, j_dv) = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(u), jnp.asarray(v)
    )

    tu, tv = _t(u).requires_grad_(), _t(v).requires_grad_()
    t_loss, t_m = PORT_LOSS[port](
        tu, tv, _t(idx), temperature=temp, log_q=_t(log_q), weights=_t(w)
    )
    t_loss.backward()

    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-4)
    np.testing.assert_allclose(float(t_m["accuracy"]), float(j_m["accuracy"]), atol=1e-6)
    np.testing.assert_allclose(
        float(t_m["logits_mean"]), float(j_m["logits_mean"]), rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(j_du), rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(j_dv), rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("off", [0, 256])
@pytest.mark.parametrize("port", sorted(PORT_BLOCK))
@pytest.mark.parametrize("ref", sorted(JAX_BLOCK))
def test_block_matches_jax(ref, port, off):
    """Block form: 256 local user rows at a global offset against all 512
    item columns (duplicate ids, zero-weight padding rows)."""
    u, v, idx, log_q, w = _inputs(2, 512, 128, dup=True)
    rows = 256
    live = w[off : off + rows] > 0  # padding rows' per-row values are garbage
    wl = np.where(live, w[off : off + rows], 0.0).astype(np.float32)

    def jax_fn(u_loc, v):
        pe, c, rd = JAX_BLOCK[ref](
            u_loc, v, _j(idx), off, temperature=0.1, log_q=_j(log_q), weights_all=_j(w)
        )
        return jnp.sum(pe * wl), (pe, c, rd)

    (_, (j_pe, j_c, j_rd)), (j_du, j_dv) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True
    )(jnp.asarray(u[off : off + rows]), jnp.asarray(v))

    tu = _t(u[off : off + rows]).requires_grad_()
    tv = _t(v).requires_grad_()
    pe, c, rd = PORT_BLOCK[port](
        tu, tv, _t(idx), off, temperature=0.1, log_q=_t(log_q), weights_all=_t(w)
    )
    torch.sum(pe * _t(wl)).backward()

    np.testing.assert_allclose(pe.detach().numpy()[live], np.asarray(j_pe)[live], rtol=1e-4)
    np.testing.assert_allclose(c.numpy()[live], np.asarray(j_c)[live])
    np.testing.assert_allclose(
        rd.numpy()[live], np.asarray(j_rd)[live], rtol=1e-3, atol=1e-4
    )
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(j_du), rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(j_dv), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("rows,batch,dim,off", [(100, 100, 24, 0), (37, 130, 200, 61)])
def test_plain_kernel_versions_match_autograd(rows, batch, dim, off):
    """The kernels' plain versions (the references ``chip_smoke.py`` holds
    the CUDA kernels to) at ragged shapes: forward against the plain loss,
    dU/dV against autograd of it."""
    u, v, idx, log_q, w = _inputs(3, batch, dim, dup=True)
    u = u[off : off + rows]
    temp = 0.1
    ids, lq, wt = _t(idx), _t(log_q), _t(w)
    cols = kernels.logq_cols(ids, lq, wt)
    tu, tv = _t(u).requires_grad_(), _t(v).requires_grad_()
    pe, _, _ = losses.in_batch_softmax_block(
        tu, tv, ids, off, temperature=temp, log_q=lq, weights_all=wt
    )
    # Padding rows' per-row values differ by design (the fused form folds
    # their +1e9 shift into the diagonal too): compare live rows, g = 0 else.
    live = w[off : off + rows] > 0
    g = np.random.default_rng(4).uniform(0, 1, rows).astype(np.float32)
    g = torch.from_numpy(np.where(live, g, 0.0).astype(np.float32))
    torch.sum(pe * g).backward()

    loss, lse, correct, pos = kernels.fwd_plain(_t(u), _t(v), ids, cols, off, 1 / temp)
    np.testing.assert_allclose(
        loss.numpy()[live], pe.detach().numpy()[live], rtol=1e-5, atol=1e-5
    )
    du = kernels.bwd_du_plain(_t(u), _t(v), ids, cols, off, lse, g, 1 / temp)
    dv = kernels.bwd_dv_plain(_t(u), _t(v), ids, cols, off, lse, g, 1 / temp)
    np.testing.assert_allclose(du.numpy(), tu.grad.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), tv.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_supported_shapes():
    # No TPU-style block, lane or VMEM limits: ragged sizes are covered.
    assert kernels.supported_for(4096, 128)
    assert kernels.supported_for(1000, 96)
    assert kernels.supported_for(16384, 512)
    assert kernels.supported_block(256, 512, 128)
    assert not kernels.supported_block(513, 512, 128)  # more rows than columns
    assert not kernels.supported_for(0, 128)


def test_block_rejects_rows_past_the_batch():
    u, v, idx, _, _ = _inputs(5, 64, 16)
    with pytest.raises(ValueError, match="row_offset"):
        kernels.fused_in_batch_softmax_block(_t(u[:32]), _t(v), _t(idx), 40)


def test_dispatch_routes_cpu_to_plain_and_rejects_other_devices():
    u, v, idx, log_q, w = _inputs(6, 64, 16)
    args = (_t(u), _t(v), _t(idx))
    kw = dict(temperature=0.1, log_q=_t(log_q), weights=_t(w))
    before = [wr.launches for wr in kernels.WRAPPERS]
    loss, _ = in_batch_softmax_loss_auto(*args, **kw)
    ref, _ = losses.in_batch_softmax_loss(*args, **kw)
    assert float(loss) == float(ref)
    assert [wr.launches for wr in kernels.WRAPPERS] == before  # no kernel on CPU
    with pytest.raises(ValueError, match="device"):
        in_batch_softmax_loss_auto(*(a.to("meta") for a in args), temperature=0.1)


def test_block_dispatch_routes_cpu_to_plain_and_rejects_other_devices():
    """A mesh rank's block (rows 32-47 of 64) goes to the plain block on the
    CPU, launching nothing; a device with neither route raises."""
    u, v, idx, log_q, w = _inputs(8, 64, 16)
    args = (_t(u[32:48]), _t(v), _t(idx), 32)
    kw = dict(temperature=0.1, log_q=_t(log_q), weights_all=_t(w))
    before = [wr.launches for wr in kernels.WRAPPERS]
    got = in_batch_softmax_block_auto(*args, **kw)
    ref = losses.in_batch_softmax_block(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert [wr.launches for wr in kernels.WRAPPERS] == before
    with pytest.raises(ValueError, match="device"):
        in_batch_softmax_block_auto(*(a.to("meta") for a in args[:3]), 32, temperature=0.1)


def test_wrappers_reject_mixed_devices():
    u, v, idx, log_q, w = _inputs(7, 64, 16)
    ids = _t(idx)
    cols = kernels.logq_cols(ids, _t(log_q), _t(w))
    with pytest.raises(ValueError, match="one CPU or CUDA device"):
        kernels.fused_fwd(_t(u), _t(v).to("meta"), ids, cols, 0, 10.0)

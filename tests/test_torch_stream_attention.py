"""Block attention over packed streams (``ops/attention.py``), the sequence
tower's MLA core. On the CPU the plain versions against the formulation the
tower ran before the kernels (block scores, a boolean mask, softmax, ``P
v``, autograd through all of it), in float32 on ragged streams: windows of
one slot, of ``max_window`` and across block edges. On the card (``cuda``
tests) the kernels against the plain versions in bfloat16, and each against
itself over two launches.

Tolerances, with their reasons:

- float32 on the CPU, plain against the old formulation: the same sums in
  another order (one logsumexp against softmax's own), a few float32 ulps:
  ``rtol 1e-5, atol 1e-6`` for outputs (O(1)); gradients ``atol 1e-5``: a
  gradient that cancels to nothing (a window of one slot has ``dS = 0``)
  keeps the rounding of ``dP - D``, each a sum of ``dv`` products of size
  up to about 10.
- The kernels against the plain versions in bfloat16 (the plain versions
  take the same bf16 operands, upcast, accumulate in float32 and round ``P``
  and ``dS`` to bf16 where the kernels do): what differs is the order of
  float32 sums and ``exp2`` for ``exp``, so a rounded ``P`` or ``dS`` may
  land one bf16 ulp (2^-8 relative) away now and then, and an output one
  bf16 ulp (2^-9 relative) away. Each output within ``REL`` = 1e-2 of its
  norm, relatively; ``lse`` (float32, no rounding to bf16) within 1e-4.

This file imports no JAX, so that the card runs its ``cuda`` tests with
``--noconftest``.
"""

import math

import numpy as np
import pytest
import torch

from twotower_tpu_torch.ops import attention, build

F32 = dict(rtol=1e-5, atol=1e-6)
F32_GRAD = dict(rtol=1e-5, atol=1e-5)
REL = 1e-2
# (window, dn, dr, dv, heads): the card's test tower's widths, and
# DeepSeek-V2-Lite's (configs/torch/seq_dsv2lite_1chip.yaml).
SHAPES = [(16, 32, 16, 32, 4), (64, 128, 64, 128, 16)]


def positions(window: int, n: int, seed: int) -> torch.Tensor:
    """``pos`` of a stream of ``n`` slots: windows of 1 and of ``window``
    slots first, then random lengths in ``[1, window]``, laid end to end and
    so across block edges; the last window cut to fit."""
    rng = np.random.default_rng(seed)
    lens = [1, window, 1, window]
    while sum(lens) < n:
        lens.append(int(rng.integers(1, window + 1)))
    pos = np.concatenate([np.arange(x) for x in lens])[:n]
    return torch.from_numpy(pos).int()


def inputs(window, dn, dr, dv, heads, n, seed, dtype=torch.float32, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn(n, heads, dn + dr, generator=gen)
    kv = torch.randn(n, heads, dn + dv, generator=gen)
    k_pe = torch.randn(n, dr, generator=gen)
    return (q.to(dtype).to(device), kv.to(dtype).to(device), k_pe.to(dtype).to(device),
            positions(window, n, seed).to(device))


def scale_of(dn: int, dr: int) -> float:
    return 1.26 ** 2 / math.sqrt(dn + dr)  # DeepSeek's, with YaRN's mscale squared


def old_attention(q, kv, k_pe, pos, window, scale):
    """The tower's attention core before the kernels: the key of every head
    built from the shared ``k_pe``, each key block copied beside the block
    before it, scores in the operands' dtype, a boolean mask, softmax."""
    n, h, dqk = q.shape
    dr = k_pe.shape[1]
    dn = dqk - dr
    dv = kv.shape[2] - dn
    k = torch.cat([kv[..., :dn], k_pe[:, None, :].expand(n, h, dr)], dim=-1)
    nb = n // window

    def keys(t):
        t = t.reshape(nb, window, h, t.shape[-1])
        t = torch.cat([t.new_zeros((1,) + t.shape[1:]), t], dim=0)
        return torch.cat([t[:-1], t[1:]], dim=1).transpose(1, 2)

    qi = torch.arange(n).view(nb, window, 1)
    ki = ((torch.arange(nb) - 1) * window)[:, None] + torch.arange(2 * window)[None, :]
    ki = ki[:, None, :]
    mask = (ki <= qi) & (ki >= qi - pos.view(nb, window, 1).long()) & (ki >= 0)
    qb = q.reshape(nb, window, h, dqk).transpose(1, 2)
    scores = torch.matmul(qb, keys(k).transpose(-1, -2)).float() * scale
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, keys(kv[..., dn:])).transpose(1, 2).reshape(n, h * dv)


def test_first_keys_is_the_old_mask():
    window, n = 16, 160
    pos = positions(window, n, 0)
    first = attention.first_keys(pos, window)
    q = torch.arange(n)
    assert torch.equal(first, torch.maximum(q - pos.long(), (q // window - 1) * window).clamp(0))
    assert bool((first == q - pos.long()).all())  # pos within its window: the window's start


@pytest.mark.parametrize("window, dn, dr, dv, heads", SHAPES)
def test_plain_forward_equals_the_old_formulation(window, dn, dr, dv, heads):
    q, kv, k_pe, pos = inputs(window, dn, dr, dv, heads, 6 * window, seed=window)
    scale = scale_of(dn, dr)
    out, lse = attention.fwd_plain(q, kv, k_pe, pos, window, scale)
    torch.testing.assert_close(out, old_attention(q, kv, k_pe, pos, window, scale), **F32)
    # lse: the row's log-sum-exp over exactly its keys
    n = q.shape[0]
    first = attention.first_keys(pos, window)
    for s in (0, 1, window - 1, window, n - 1):
        k = torch.cat([kv[first[s]:s + 1, :, :dn], k_pe[first[s]:s + 1, None, :].expand(
            -1, heads, dr)], dim=-1)
        want = torch.logsumexp(torch.einsum("hd,khd->hk", q[s], k) * scale, dim=-1)
        torch.testing.assert_close(lse[:, s], want, **F32)


@pytest.mark.parametrize("window, dn, dr, dv, heads", SHAPES)
def test_plain_backward_equals_autograd_through_the_old_formulation(window, dn, dr, dv, heads):
    q, kv, k_pe, pos = inputs(window, dn, dr, dv, heads, 6 * window, seed=window + 1)
    scale = scale_of(dn, dr)
    dout = torch.randn(q.shape[0], heads * dv, generator=torch.Generator().manual_seed(9))
    leaves = [t.clone().requires_grad_(True) for t in (q, kv, k_pe)]
    old_attention(*leaves, pos, window, scale).backward(dout)
    out, lse = attention.fwd_plain(q, kv, k_pe, pos, window, scale)
    dq, delta = attention.dq_plain(q, kv, k_pe, pos, window, scale, out, lse, dout)
    dkv, dk_pe = attention.dkv_plain(q, kv, k_pe, pos, window, scale, lse, delta, dout)
    for got, leaf in zip((dq, dkv, dk_pe), leaves):  # dk_nope and dv are dkv's two halves
        torch.testing.assert_close(got, leaf.grad, **F32_GRAD)


def test_the_autograd_function_runs_the_plain_versions_on_the_cpu():
    window, dn, dr, dv, heads = SHAPES[0]
    q, kv, k_pe, pos = inputs(window, dn, dr, dv, heads, 4 * window, seed=3)
    scale = scale_of(dn, dr)
    dout = torch.randn(q.shape[0], heads * dv, generator=torch.Generator().manual_seed(4))
    build.reset_launch_counts()
    leaves = [t.clone().requires_grad_(True) for t in (q, kv, k_pe)]
    out = attention.stream_attention(*leaves, pos, window, scale)
    out.backward(dout)
    ref = [t.clone().requires_grad_(True) for t in (q, kv, k_pe)]
    old_attention(*ref, pos, window, scale).backward(dout)
    torch.testing.assert_close(out, old_attention(q, kv, k_pe, pos, window, scale), **F32)
    for a, b in zip(leaves, ref):
        torch.testing.assert_close(a.grad, b.grad, **F32_GRAD)
    assert [w.launches for w in attention.WRAPPERS] == [0, 0, 0]  # no kernel on the CPU


def test_bfloat16_scores_no_longer_round():
    """In bfloat16 the plain forward lies closer to the float32 result than
    the old one, whose scores rounded to bfloat16 out of the product."""
    window, dn, dr, dv, heads = SHAPES[1]
    q, kv, k_pe, pos = inputs(window, dn, dr, dv, heads, 4 * window, seed=5, dtype=torch.bfloat16)
    scale = scale_of(dn, dr)
    exact = old_attention(q.float(), kv.float(), k_pe.float(), pos, window, scale)
    new, _ = attention.fwd_plain(q, kv, k_pe, pos, window, scale)
    old = old_attention(q, kv, k_pe, pos, window, scale)

    def err(t):
        return float((t.float() - exact).norm() / exact.norm())

    assert err(new) < 0.8 * err(old)


def test_a_stream_not_a_multiple_of_the_window_is_refused():
    q, kv, k_pe, pos = inputs(16, 32, 16, 32, 2, 40, seed=0)
    with pytest.raises(ValueError, match="multiple of window"):
        attention.fwd_plain(q, kv, k_pe, pos, 16, 0.1)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("window, dn, dr, dv, heads, n", [
    (16, 32, 16, 32, 4, 256), (16, 32, 16, 32, 4, 16 * 37),  # a last query block ragged
    (64, 128, 64, 128, 16, 32768)])
def test_kernels_match_the_plain_versions(cuda_device, window, dn, dr, dv, heads, n):
    q, kv, k_pe, pos = inputs(window, dn, dr, dv, heads, n, seed=n, dtype=torch.bfloat16,
                              device=cuda_device)
    scale = scale_of(dn, dr)
    dout = torch.randn(n, heads * dv, device=cuda_device).to(torch.bfloat16)
    args = (q, kv, k_pe, pos, window, scale)
    build.reset_launch_counts()
    runs = []
    for _ in range(2):
        out, lse = attention.attention_fwd(*args)
        dq, delta = attention.attention_dq(*args, out, lse, dout)
        dkv, dk_pe = attention.attention_dkv(*args, lse, delta, dout)
        runs.append((out, lse, dq, delta, dkv, dk_pe))
    torch.cuda.synchronize()
    assert [w.launches for w in attention.WRAPPERS] == [2, 2, 2]
    for a, b in zip(*runs):
        assert torch.equal(a, b)  # two launches, the same bits
    out, lse, dq, delta, dkv, dk_pe = runs[0]
    cpu = [t.cpu() for t in args[:4]]
    out_p, lse_p = attention.fwd_plain(*cpu, window, scale)
    torch.testing.assert_close(lse.cpu(), lse_p, rtol=0, atol=1e-4)
    assert _rel(out.cpu(), out_p) < REL
    dq_p, delta_p = attention.dq_plain(*cpu, window, scale, out.cpu(), lse.cpu(), dout.cpu())
    torch.testing.assert_close(delta.cpu(), delta_p, rtol=1e-5, atol=1e-5)
    dkv_p, dk_pe_p = attention.dkv_plain(*cpu, window, scale, lse.cpu(), delta.cpu(), dout.cpu())
    assert _rel(dq.cpu(), dq_p) < REL
    assert _rel(dkv.cpu()[..., :dn], dkv_p[..., :dn]) < REL  # dk_nope
    assert _rel(dkv.cpu()[..., dn:], dkv_p[..., dn:]) < REL  # dv
    assert _rel(dk_pe.cpu(), dk_pe_p) < REL


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take(cuda_device):
    q, kv, k_pe, pos = inputs(16, 32, 16, 32, 2, 64, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="stream attention kernel"):  # float32
        attention.attention_fwd(q, kv, k_pe, pos, 16, 0.1)
    q, kv, k_pe = (t.to(torch.bfloat16) for t in (q, kv, k_pe))
    with pytest.raises(ValueError, match="stream attention kernel"):  # no such instantiation
        attention.attention_fwd(q, kv, k_pe, pos, 32, 0.1)
    out, lse = attention.attention_fwd(q, kv, k_pe, pos, 16, 0.1)
    with pytest.raises(ValueError, match="stream attention kernel"):  # a float32 gradient
        attention.attention_dq(q, kv, k_pe, pos, 16, 0.1, out, lse, out.float())

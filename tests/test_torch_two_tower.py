"""The port's towers and ``forward`` against the JAX package at dropout 0,
from bridged parameters.

Tolerances: with ``compute_dtype=float32`` both sides do the same float32
arithmetic up to summation order, so rtol 1e-5 / atol 1e-6. With bfloat16
both round the GEMM operands and the hidden activations to bf16; where the
two float32 accumulations differ in their last bit a hidden value can round
to the neighbouring bf16 value (2^-8 relative), and that propagates through
the later layers, so the unit-norm outputs are held to atol 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import two_tower
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTHS = {
    "model.embedding_dim": 32,
    "model.user_tower_dims": [64, 48, 32],
    "model.item_tower_dims": [64, 32],
    "model.dropout_rate": 0.0,
}
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=0, atol=2e-2)}


def _configs(dtype, normalize=True):
    over = {**WIDTHS, "model.compute_dtype": dtype, "model.normalize_embeddings": normalize}
    return JaxConfig().with_overrides(over), Config().with_overrides(over)


def _bridged(jcfg):
    jparams = jtt.init_params(jax.random.PRNGKey(0), jcfg.model, 300, 200)
    return jparams, bridge.params_from_numpy(jax.device_get(jparams))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype, normalize):
    jcfg, cfg = _configs(dtype, normalize)
    jparams, params = _bridged(jcfg)
    rng = np.random.default_rng(0)
    u_idx = rng.integers(0, 300, 64).astype(np.int32)
    i_idx = rng.integers(0, 200, 64).astype(np.int32)

    ju, ji = jtt.forward(jparams, jnp.asarray(u_idx), jnp.asarray(i_idx), jcfg.model, train=True)
    tu, ti = two_tower.forward(
        params, torch.from_numpy(u_idx), torch.from_numpy(i_idx), cfg.model, train=True
    )
    assert tu.dtype == torch.float32 and ti.dtype == torch.float32  # f32 out in bf16 mode
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[dtype])
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tower_gradient_matches_jax(dtype):
    """Gradient of a scalar of the user tower w.r.t. the gathered rows —
    what the sparse step differentiates."""
    jcfg, cfg = _configs(dtype)
    jparams, params = _bridged(jcfg)
    rows = np.random.default_rng(1).normal(size=(32, 32)).astype(np.float32)
    weights = np.random.default_rng(2).normal(size=(32, 32)).astype(np.float32)

    jg = jax.grad(
        lambda r: jnp.sum(jtt.apply_user_tower(jparams, r, jcfg.model) * weights)
    )(jnp.asarray(rows))
    tr = torch.from_numpy(rows).requires_grad_()
    torch.sum(two_tower.apply_user_tower(params, tr, cfg.model) * torch.from_numpy(weights)).backward()
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == "float32" else dict(rtol=0, atol=5e-2)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(jg), **tol)


def test_padding_and_init_shapes_match_jax():
    for n in (0, 1, 127, 128, 1000, 1_000_000):
        assert two_tower.padded_rows(n) == jtt.padded_rows(n)
    jcfg, cfg = _configs("bfloat16")
    jparams = jax.device_get(jtt.init_params(jax.random.PRNGKey(0), jcfg.model, 300, 200))
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 300, 200)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), t)  # noqa: E731
    assert shapes(bridge.params_to_numpy(params)) == shapes(jparams)
    assert two_tower.dead_row(params["item_embedding"]) == 255


def test_dropout_uses_the_generator():
    _, cfg = _configs("float32")
    cfg = cfg.with_overrides({"model.dropout_rate": 0.5})
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 300, 200)
    idx = torch.arange(16)
    a = two_tower.embed_users(params, idx, cfg.model, train=True,
                              dropout_gen=torch.Generator().manual_seed(5))
    b = two_tower.embed_users(params, idx, cfg.model, train=True,
                              dropout_gen=torch.Generator().manual_seed(5))
    c = two_tower.embed_users(params, idx, cfg.model, train=False)
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)

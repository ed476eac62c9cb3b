"""The port's sharded serving against the JAX package's and against the
port's one-device index: ``RetrievalIndex(mesh=[cpu] * 8)`` (one process,
eight shards) = the JAX index on a mesh of the 8 forced CPU devices
(``tests/test_serving_checkpoint.py::test_mesh_sharded_index_matches_single``,
100 users, 60 items, its four corpus variants) = the port's one-device
index; ``similar_items`` and ``recommend_by_history`` on the sharded
index; a text tower's corpus encoded shard by shard; the sharded approximate
search's ``item_scale_shard`` against JAX's; ``serve-model --shard-corpus``
on a checkpoint; the FastAPI front's missing import.

Tolerances: scores rtol 1e-5 (float32 towers; JAX and the port differ in
summation order only); ids equal outside exactly tied scores
(``test_torch_serving_index.assert_same_results``); the port's sharded and
one-device indexes agree bit for bit (the same encode and the same
per-shard searches).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_serving_cli import trained  # noqa: F401  (module fixture)
from test_torch_serving_index import _configs, _params, assert_same_results
from twotower_tpu.ops.topk import quantize_corpus as jax_quantize
from twotower_tpu.ops.topk import topk_mips_approx_sharded as jax_approx_sharded
from twotower_tpu.serving.index import RetrievalIndex as JaxIndex
from twotower_tpu_torch.config import load_config_for_checkpoint
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops.topk import quantize_corpus, topk_mips_approx_sharded
from twotower_tpu_torch.serving import RetrievalIndex
from twotower_tpu_torch.serving.api import RecommendService, build_service, create_fastapi_app

SHARDS = 8
VARIANTS = {
    "bf16": ("tpu_mips", "auto"),
    "int8": ("tpu_mips", "int8"),
    "int8_rowscale": ("tpu_mips", "int8_rowscale"),
    "exact": ("tpu_mips_exact", "auto"),
}


def _indexes(variant, num_users=100, num_items=60):
    jcfg, cfg = _configs(*VARIANTS[variant])
    jparams, params = _params(jcfg, num_users, num_items)
    jmesh = Mesh(np.array(jax.devices()[:SHARDS]), ("model",))
    return (JaxIndex(jcfg, jparams, num_users, num_items, mesh=jmesh),
            RetrievalIndex(cfg, params, num_users, num_items, mesh=["cpu"] * SHARDS),
            RetrievalIndex(cfg, params, num_users, num_items, device="cpu"))


def _equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_index_matches_jax_sharded_and_single(variant):
    jax_sh, sharded, single = _indexes(variant)
    assert len(sharded.corpus) == SHARDS and sharded.mesh == [torch.device("cpu")] * SHARDS
    users = np.arange(25, dtype=np.int32)
    got = sharded.recommend(users, k=7)
    assert_same_results(got, jax_sh.recommend(users, k=7))
    _equal(got, single.recommend(users, k=7))
    # Padding rows (global index >= 60) never surface, at any k.
    _, ids = sharded.recommend(users, k=60)
    assert ids.max() < 60 and all(len(set(r)) == 60 for r in ids)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_similar_items_and_history(variant):
    jax_sh, sharded, single = _indexes(variant)
    items = np.array([3, 9, 59, 0])
    got = sharded.similar_items(items, k=5)
    _equal(got, single.similar_items(items, k=5))
    assert_same_results(got, jax_sh.similar_items(items, k=5))
    assert all(i not in row for i, row in zip(items, got[1]))
    hist = np.array([[1, 2, 58, -1], [40, -1, -1, -1], [7, 7, 30, 59]])
    got = sharded.recommend_by_history(hist, k=6)
    _equal(got, single.recommend_by_history(hist, k=6))
    assert_same_results(got, jax_sh.recommend_by_history(hist, k=6))


def test_sharded_text_tower_corpus_equals_single():
    """A model with a text tower: each shard pools its items' token rows,
    gathered from the shards of the text table that own them."""
    _, cfg = _configs("tpu_mips", "float32",
                      {"model.text_buckets": 64, "model.text_tokens": 4})
    params = two_tower.init_params(torch.Generator().manual_seed(3), cfg.model, 50, 45)
    tokens = np.random.default_rng(4).integers(0, 64, (45, 4))
    sharded = RetrievalIndex(cfg, params, 50, 45, item_tokens=tokens, mesh=["cpu"] * 3)
    single = RetrievalIndex(cfg, params, 50, 45, item_tokens=tokens, device="cpu")
    _equal(sharded.recommend(np.arange(50), k=10), single.recommend(np.arange(50), k=10))
    _equal(sharded.similar_items(np.arange(45), k=4), single.similar_items(np.arange(45), k=4))


@pytest.mark.parametrize("per_row", [False, True], ids=["global_scale", "per_row_scale"])
def test_approx_sharded_item_scale_shard_matches_jax(per_row):
    """The one-process sharded search over int8 shards with
    ``item_scale_shard`` (the replicated global scale, or each shard's
    per-row slice) against JAX's ``shard_map`` over 4 devices."""
    rng = np.random.default_rng(5)
    n, rows, k = 90, 32, 9  # 4 shards of 32 rows, a padding tail of 38
    corpus = np.zeros((4 * rows, 16), np.float32)
    corpus[:n] = rng.normal(size=(n, 16))
    query = rng.normal(size=(6, 16)).astype(np.float32)
    jq, jscale = jax_quantize(jnp.asarray(corpus), per_row=per_row)
    mesh = Mesh(np.array(jax.devices()[:4]), ("model",))
    want = shard_map(
        lambda q, c, s: jax_approx_sharded(q, c, k, axis_name="model", num_items=n,
                                           item_scale_shard=s),
        mesh=mesh, in_specs=(P(), P("model", None), P("model") if per_row else P()),
        out_specs=(P(), P()), check_rep=False,
    )(jnp.asarray(query), jq, jscale)
    q, scale = quantize_corpus(torch.as_tensor(corpus), per_row=per_row)
    shards = list(q.split(rows))
    scales = list(scale.split(rows)) if per_row else scale
    got = topk_mips_approx_sharded(torch.as_tensor(query), shards, k, num_items=n,
                                   item_scale_shard=scales)
    assert_same_results((got[0].numpy(), got[1].to(torch.int32).numpy()),
                        (np.asarray(want[0]), np.asarray(want[1])))


def _sharded_service(cfg, ckpt, devices):
    """``build_service``'s service over a checkpoint, its index sharded over
    ``devices`` (which may repeat)."""

    def factory(step=None):
        return RetrievalIndex.from_checkpoint(cfg, ckpt, step=step, mesh=devices)

    index = factory()
    return RecommendService(index, index.vocab, default_k=cfg.serving.top_k,
                            max_batch=cfg.serving.max_batch_size, index_factory=factory,
                            max_exclude=cfg.serving.max_exclude,
                            max_history=cfg.serving.max_history)


def test_serve_model_shard_corpus_builds_on_the_cpu(trained):  # noqa: F811
    """``build_service(shard_corpus=True)`` shards over the CPU when the CPU is
    named and serves as the one-device service; a service over three CPU
    shards does too, and rebuilds its sharded index on reload."""
    cfg = load_config_for_checkpoint(trained, None, {})
    one = build_service(cfg, str(trained), device="cpu")
    cpu = build_service(cfg, str(trained), device="cpu", shard_corpus=True)
    three = _sharded_service(cfg, str(trained), ["cpu"] * 3)
    assert cpu.index.mesh == [torch.device("cpu")] and len(three.index.corpus) == 3
    payload = {"user_idx": list(range(5)), "k": 4}

    def results(svc):
        return svc.recommend(payload)["results"]

    want = results(one)
    assert results(cpu) == want == results(three)
    info = three.reload(release_first=True)
    assert info["generation"] == 1 and len(three.index.corpus) == 3
    assert results(three) == want


def test_fastapi_front_names_its_missing_package(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "fastapi", None)  # import raises ImportError
    with pytest.raises(ImportError, match="fastapi"):
        create_fastapi_app(object())

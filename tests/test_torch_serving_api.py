"""The port's serving core (``serving/api.py``): the substance of the JAX
package's ``tests/test_serving_checkpoint.py`` (``TestRecommendService``,
``TestHotReload``, ``TestMicroBatcher``, ``TestServingHardening``,
``TestExclusionAndHistory``, ``TestAiohttpApp``) run against the port's
service over the port's index on the CPU.

The aiohttp cases run through ``aiohttp.test_utils`` and skip where aiohttp
is not installed (the core itself needs no HTTP package).
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.serving import RetrievalIndex
from twotower_tpu_torch.serving.api import (
    CoalescedRoutes,
    MicroBatcher,
    RecommendService,
    ServingError,
    batcher_key,
    batchers_key,
    create_app,
)

CFG = Config().with_overrides({
    "model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
    "model.item_tower_dims": [32, 16],
})


def _index(num_users=100, num_items=60, seed=0, vocab=True):
    params = two_tower.init_params(torch.Generator().manual_seed(seed), CFG.model,
                                   num_users, num_items)
    index = RetrievalIndex(CFG, params, num_users, num_items, device="cpu")
    if vocab:
        index.vocab = _FakeVocab(num_users, num_items)
    return index


class _FakeVocab:
    """Minimal vocab pair for service tests."""

    class _One:
        def __init__(self, prefix, n):
            self.ids = np.array([f"{prefix}{i}" for i in range(n)], object)

        def encode(self, raw, missing=-1):
            index = {v: i for i, v in enumerate(self.ids)}
            return np.array([index.get(str(r), missing) for r in raw], np.int32)

        def decode(self, idx):
            return self.ids[np.asarray(idx)]

    def __init__(self, nu, ni):
        self.users = self._One("U", nu)
        self.items = self._One("I", ni)


class _CountingIndex:
    """Index stub recording every device call (for coalescing asserts)."""

    num_users, num_items = 1000, 500

    def __init__(self, delay_s: float = 0.0):
        self.calls: list[int] = []
        self.delay_s = delay_s

    def recommend(self, user_idx, k):
        if self.delay_s:
            time.sleep(self.delay_s)
        self.calls.append(len(user_idx))
        b = len(user_idx)
        idx = (np.asarray(user_idx)[:, None] + np.arange(k)[None, :]) % self.num_items
        return np.arange(k, 0, -1, dtype=np.float32)[None].repeat(b, 0), idx.astype(np.int32)

    def similar_items(self, item_idx, k):
        return self.recommend(item_idx, k)

    def recommend_by_history(self, hist_idx, k):
        rows = np.asarray(hist_idx)
        return self.recommend(np.where(rows.max(axis=1) >= 0, rows.max(axis=1), 0), k)


@pytest.fixture(scope="module")
def small_index():
    return _index()


@pytest.fixture(scope="module")
def service(small_index):
    return RecommendService(small_index, _FakeVocab(100, 60), default_k=10)


def _aiohttp():
    return pytest.importorskip("aiohttp.test_utils")


def _serve(app, body):
    """Run ``body(client)`` against ``app`` in a test server."""
    tu = _aiohttp()

    async def go():
        async with tu.TestClient(tu.TestServer(app)) as client:
            return await body(client)

    return asyncio.run(go())


# --- RecommendService ---------------------------------------------------------


def test_recommend_by_user_id_and_batch(service):
    out = service.recommend({"user_id": "U3", "k": 5})
    assert len(out["results"]) == 1 and len(out["results"][0]["items"]) == 5
    assert out["results"][0]["items"][0].startswith("I") and out["latency_ms"] >= 0
    assert len(service.recommend({"user_idx": [0, 1, 2], "k": 3})["results"]) == 3


def test_recommend_matches_the_index(service, small_index):
    out = service.recommend({"user_idx": [4, 9], "k": 6})
    scores, items = small_index.recommend(np.array([4, 9]), 6)
    for row, s, i in zip(out["results"], scores, items):
        assert row["item_idx"] == i.tolist()
        np.testing.assert_allclose(row["scores"], s, atol=1e-6)


@pytest.mark.parametrize(
    "payload,status,match",
    [({"user_id": "NOPE"}, 404, "unknown"), ({"k": 5}, 400, "user_id"),
     ({"user_idx": [], "k": 5}, 400, "non-empty"), ({"user_idx": [1], "k": "x"}, 400, "k"),
     ({"user_idx": [1], "k": 61}, 400, "k must be"), ({"user_idx": [100]}, 404, "range"),
     ([1, 2], 400, "JSON object")],
)
def test_recommend_validation(service, payload, status, match):
    with pytest.raises(ServingError, match=match) as e:
        service.recommend(payload)
    assert e.value.status == status


def test_similar_items(service):
    out = service.similar_items({"item_id": "I5", "k": 4})
    assert len(out["results"][0]["items"]) == 4
    assert "I5" not in out["results"][0]["items"]
    with pytest.raises(ServingError, match="non-empty"):
        service.similar_items({"item_idx": [], "k": 5})


def test_health(service):
    h = service.health()
    assert h["status"] == "ok" and h["num_items"] == 60 and h["model_generation"] == 0


def test_default_k_clamps_for_similar_items_on_tiny_catalog():
    """A default k wider than the catalog must not 400 k-less requests on
    either endpoint: /similar_items caps at num_items - 1."""
    svc = RecommendService(_index(10, 5, vocab=False), _FakeVocab(10, 5), default_k=100)
    assert len(svc.recommend({"user_idx": [0]})["results"][0]["items"]) == 5
    assert len(svc.similar_items({"item_idx": [2]})["results"][0]["items"]) == 4
    with pytest.raises(ServingError):  # an explicit k is still strict
        svc.similar_items({"item_idx": [2], "k": 5})


# --- hot reload -----------------------------------------------------------------


def test_reload_swaps_index_vocab_and_default_k(small_index):
    bigger = _index(100, 80, seed=7)
    bigger.checkpoint_step = 42
    calls = []

    def factory(step=None):
        calls.append(step)
        return bigger

    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=70, index_factory=factory)
    assert svc.default_k == 60  # clamped to the first catalog
    info = svc.reload()
    assert calls == [None]
    assert svc.index is bigger and svc.vocab is bigger.vocab
    assert svc.default_k == 70  # re-clamped: the 80-item catalog fits it
    assert info["checkpoint_step"] == 42 and info["generation"] == 1
    h = svc.health()
    assert h["checkpoint_step"] == 42 and h["model_generation"] == 1
    assert len(svc.recommend({"user_idx": [0]})["results"][0]["items"]) == 70


@pytest.mark.parametrize("factory,step", [(None, None), (lambda step=None: None, "nope")])
def test_reload_rejects_bad_requests(small_index, factory, step):
    svc = RecommendService(small_index, _FakeVocab(100, 60), index_factory=factory)
    with pytest.raises(ServingError) as e:
        svc.reload(step)
    assert e.value.status == 400


def test_request_snapshot_survives_mid_flight_reload(small_index):
    smaller = _index(40, 20, seed=9)
    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=10,
                           index_factory=lambda step=None: smaller)
    user_idx, k, _excl, snap = svc.prepare_recommend({"user_idx": [75], "k": 40})
    svc.reload()  # swaps to the 20-item / 40-user model
    scores, items = snap.index.recommend(user_idx, k)  # still the old model
    assert items.shape == (1, 40) and (items < 60).all()
    out = svc.format_recommend(user_idx, scores, items, k, 0.0, snap.vocab)
    assert all(i.startswith("I") for i in out["results"][0]["items"])
    with pytest.raises(ServingError) as e:  # new requests: user 75 is gone
        svc.recommend({"user_idx": [75]})
    assert e.value.status == 404


def test_release_first_503s_until_reload_succeeds(small_index):
    calls = {"n": 0}

    def flaky_factory(step=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("encode OOM")
        return small_index

    svc = RecommendService(small_index, _FakeVocab(100, 60), index_factory=flaky_factory)
    with pytest.raises(RuntimeError):
        svc.reload(release_first=True)
    assert svc.health()["status"] == "reloading"
    with pytest.raises(ServingError) as e:
        svc.recommend({"user_idx": [0]})
    assert e.value.status == 503
    svc.reload(release_first=True)
    assert svc.health()["status"] == "ok"
    assert svc.recommend({"user_idx": [0], "k": 3})["results"]


def test_pre_swap_runs_on_new_index_before_swap(small_index):
    new_index = _CountingIndex()
    svc = RecommendService(small_index, _FakeVocab(100, 60),
                           index_factory=lambda step=None: new_index)
    seen = {}

    def pre_swap(idx):
        seen["index"], seen["live_at_call"] = idx, svc.index

    svc.reload(pre_swap=pre_swap)
    assert seen == {"index": new_index, "live_at_call": small_index}
    assert svc.index is new_index


def test_pre_swap_failure_aborts_swap(small_index):
    svc = RecommendService(small_index, _FakeVocab(100, 60),
                           index_factory=lambda step=None: _CountingIndex())

    def boom(idx):
        raise RuntimeError("warmup failed")

    with pytest.raises(RuntimeError):
        svc.reload(pre_swap=boom)
    assert svc.index is small_index and svc.reloads == 0  # blue-green: old model live


def test_batcher_never_coalesces_across_index_swap():
    old_index, new_index = _CountingIndex(delay_s=0.02), _CountingIndex(delay_s=0.02)
    batcher = MicroBatcher(old_index, max_batch=64, window_ms=100.0)

    async def go():
        first = asyncio.ensure_future(
            batcher.recommend(np.array([1], np.int32), 5, index=old_index))
        await asyncio.sleep(0.005)  # the window opens on old_index
        second = asyncio.ensure_future(
            batcher.recommend(np.array([2], np.int32), 5, index=new_index))
        return await asyncio.gather(first, second)

    r1, r2 = asyncio.run(go())
    assert r1[0].shape == (1, 5) and r2[0].shape == (1, 5)
    assert old_index.calls == [1] and new_index.calls == [1]


def test_aiohttp_admin_reload_end_to_end(small_index):
    new_index = _index(100, 60, seed=5)
    new_index.checkpoint_step = 11
    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=10,
                           index_factory=lambda step=None: new_index)

    async def body(client):
        before = await (await client.post("/recommend", json={"user_idx": [1], "k": 5})).json()
        r = await client.post("/admin/reload")
        assert r.status == 200
        info = await r.json()
        assert info["checkpoint_step"] == 11 and info["generation"] == 1
        assert (await (await client.get("/health")).json())["checkpoint_step"] == 11
        after = await (await client.post("/recommend", json={"user_idx": [1], "k": 5})).json()
        assert (await client.post("/admin/reload", json={"step": "nope"})).status == 400
        return before, after

    before, after = _serve(create_app(svc), body)
    assert before["results"][0] != after["results"][0]  # other params, other ranking


def test_aiohttp_release_first_drops_batcher_pin_and_500_is_json(small_index):
    calls = {"n": 0}
    pins: list = []
    replacement = _CountingIndex()

    def flaky_factory(step=None):
        calls["n"] += 1
        pins.append(flaky_factory.batcher.index)  # what the batcher pins
        if calls["n"] == 1:
            raise RuntimeError("encode OOM")
        return replacement

    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=10,
                           index_factory=flaky_factory)
    app = create_app(svc)
    flaky_factory.batcher = app[batcher_key()]

    async def body(client):
        r = await client.post("/admin/reload", json={"release_first": True})
        assert r.status == 500 and "reload failed" in (await r.json())["error"]
        assert (await (await client.get("/health")).json())["status"] == "reloading"
        r = await client.post("/admin/reload", json={"release_first": True})
        assert r.status == 200
        assert (await (await client.get("/health")).json())["status"] == "ok"

    _serve(app, body)
    assert pins == [None, None]
    assert app[batcher_key()].index is replacement


# --- MicroBatcher -----------------------------------------------------------------


def test_concurrent_requests_coalesce():
    index = _CountingIndex(delay_s=0.01)
    batcher = MicroBatcher(index, max_batch=256, window_ms=20.0)

    async def go():
        return await asyncio.gather(
            *(batcher.recommend(np.array([u], np.int32), 5) for u in range(32)))

    results = asyncio.run(go())
    for u, (scores, items) in enumerate(results):
        assert scores.shape == items.shape == (1, 5)
        np.testing.assert_array_equal(items[0], (u + np.arange(5)) % index.num_items)
    assert len(index.calls) < 32 and sum(index.calls) >= 32


@pytest.mark.parametrize("max_batch,rows,bucket", [(256, 3, 4), (100, 70, 100)])
def test_groups_pad_to_warmed_buckets(max_batch, rows, bucket):
    """Powers of two clamped to max_batch: 3 rows pad to 4, and a 70-row
    group under max_batch=100 pads to the 100-row clamp bucket (not 128),
    which warmup covers."""
    index = _CountingIndex()
    batcher = MicroBatcher(index, max_batch=max_batch, window_ms=1.0)
    shapes = batcher.warmup(5)
    warmed = set(index.calls)
    assert max_batch in warmed and shapes == len(warmed)
    index.calls.clear()
    scores, _ = asyncio.run(batcher.recommend(np.arange(rows, dtype=np.int32), 5))
    assert scores.shape == (rows, 5)
    assert index.calls == [bucket] and bucket in warmed


def test_device_error_propagates():
    class _Boom:
        def recommend(self, user_idx, k):
            raise RuntimeError("device on fire")

    with pytest.raises(RuntimeError, match="device on fire"):
        asyncio.run(MicroBatcher(_Boom(), window_ms=1.0).recommend(np.array([0], np.int32), 5))


def test_group_never_exceeds_max_batch():
    index = _CountingIndex(delay_s=0.01)
    batcher = MicroBatcher(index, max_batch=8, window_ms=50.0)

    async def go():
        return await asyncio.gather(
            batcher.recommend(np.array([0], np.int32), 5),
            batcher.recommend(np.arange(8, dtype=np.int32), 5),
            batcher.recommend(np.arange(3, dtype=np.int32), 5),
        )

    results = asyncio.run(go())
    assert all(r[0].shape[1] == 5 for r in results)
    assert max(index.calls) <= 8 and len(index.calls) >= 2


def test_oversize_direct_batch_raises_clear_error():
    batcher = MicroBatcher(_CountingIndex(), max_batch=8, window_ms=1.0)
    with pytest.raises(ServingError, match="batch too large"):
        asyncio.run(batcher.recommend(np.zeros(9, np.int32), 5))


def test_warmup_against_explicit_index_and_clamped_k():
    live, incoming = _CountingIndex(), _CountingIndex()
    batcher = MicroBatcher(live, max_batch=8, window_ms=1.0)
    assert batcher.warmup(5, index=incoming) == len(incoming.calls) > 0
    assert live.calls == []  # the old index untouched

    class _TinyCatalog(_CountingIndex):
        num_items = 7

        def recommend(self, user_idx, k):
            if k > self.num_items:
                raise ValueError(f"k={k} exceeds corpus size {self.num_items}")
            return super().recommend(user_idx, k)

    assert MicroBatcher(_TinyCatalog(), max_batch=4, window_ms=1.0).warmup(100) == 3


def test_worker_cancellation_fails_waiters():
    index = _CountingIndex(delay_s=0.2)
    batcher = MicroBatcher(index, max_batch=4, window_ms=1.0)

    async def go():
        t1 = asyncio.ensure_future(batcher.recommend(np.array([0], np.int32), 5))
        await asyncio.sleep(0.05)  # the worker is busy in the executor
        t2 = asyncio.ensure_future(batcher.recommend(np.array([1], np.int32), 5))
        await asyncio.sleep(0.01)
        batcher._worker.cancel()
        return await asyncio.gather(t1, t2, return_exceptions=True)

    for r in asyncio.run(go()):
        assert isinstance(r, (RuntimeError, asyncio.CancelledError))


def test_lone_request_skips_coalesce_window():
    index = _CountingIndex()
    batcher = MicroBatcher(index, max_batch=8, window_ms=2000.0)

    async def go():
        t0 = time.perf_counter()
        await batcher.recommend(np.zeros(1, np.int32), 3)
        return time.perf_counter() - t0

    assert asyncio.run(go()) < 0.5 and len(index.calls) == 1


def test_history_coalescing_mixed_widths_and_k(service):
    async def go():
        b = MicroBatcher(service.index, max_batch=16, window_ms=30.0,
                         method="recommend_by_history", pad_value=-1, pad_width=8,
                         query_dtype=np.int64)
        h1, h2 = np.array([[2]], np.int64), np.array([[3, 4, 5]], np.int64)
        (s1, i1), (s2, i2) = await asyncio.gather(b.submit(h1, 4), b.submit(h2, 6))
        assert s1.shape == i1.shape == (1, 4) and s2.shape == i2.shape == (1, 6)
        ds, di = service.index.recommend_by_history(h1, 4)  # direct, unpadded
        np.testing.assert_array_equal(i1, di)
        np.testing.assert_allclose(s1, ds, rtol=1e-5)
        return b.batches

    assert asyncio.run(go()) >= 1


def test_coalesced_routes_without_http(service, small_index):
    """The three routes' coalesced handlers under asyncio alone give the
    synchronous service's answers (what serving on a machine without
    aiohttp runs)."""
    routes = CoalescedRoutes(service, window_ms=5.0)
    assert routes.warmup(service.default_k) > 0
    payloads = [("recommend", {"user_idx": [3], "k": 5, "exclude_idx": [0, 1]}),
                ("similar_items", {"item_idx": [4], "k": 4}),
                ("recommend_by_history", {"history_idx": [2, 8], "k": 5})]

    async def go():
        return await asyncio.gather(*(getattr(routes, name)(p) for name, p in payloads))

    for (name, payload), got in zip(payloads, asyncio.run(go())):
        want = getattr(service, name)(payload)
        assert [r["item_idx"] for r in got["results"]] == [r["item_idx"] for r in want["results"]]
    assert all(b.batches >= 1 for b in routes.batchers.values())


# --- aiohttp app ------------------------------------------------------------------


def test_routes(service):
    async def body(client):
        assert (await client.get("/health")).status == 200
        r = await client.post("/recommend", json={"user_idx": [1], "k": 3})
        assert r.status == 200 and len((await r.json())["results"][0]["items"]) == 3
        assert (await client.post("/recommend", json={"user_id": "NOPE"})).status == 404
        assert (await client.post("/recommend", data=b"not json")).status == 400

    _serve(create_app(service), body)


def test_aiohttp_coalesced_end_to_end(service):
    async def body(client):
        rs = await asyncio.gather(
            *(client.post("/recommend", json={"user_idx": [u], "k": 3}) for u in range(8)))
        assert all(r.status == 200 for r in rs)
        for u, b in enumerate(await asyncio.gather(*(r.json() for r in rs))):
            assert b["results"][0]["user_idx"] == u and len(b["results"][0]["items"]) == 3
        assert (await (await client.get("/health")).json())["coalesced_batches"] >= 1

    _serve(create_app(service, coalesce=True, window_ms=5.0), body)


def test_mixed_endpoints_all_coalesce(service):
    per_route = 8
    app = create_app(service, coalesce=True, window_ms=20.0)

    async def body(client):
        reqs = []
        for u in range(per_route):
            reqs += [client.post("/recommend", json={"user_idx": [u], "k": 3}),
                     client.post("/similar_items", json={"item_idx": [u], "k": 4}),
                     client.post("/recommend_by_history", json={"history_idx": [u, u + 1], "k": 5})]
        rs = await asyncio.gather(*reqs)
        assert all(r.status == 200 for r in rs)
        bodies = await asyncio.gather(*(r.json() for r in rs))
        for i in range(per_route):
            rec, sim, hist = bodies[3 * i: 3 * i + 3]
            assert rec["results"][0]["user_idx"] == i and len(rec["results"][0]["items"]) == 3
            assert sim["results"][0]["item_idx"] == i and f"I{i}" not in sim["results"][0]["items"]
            got = hist["results"][0]["item_idx"]
            assert len(got) == 5 and i not in got and (i + 1) not in got
        fams = app[batchers_key()]
        assert set(fams) == {"recommend", "similar_items", "recommend_by_history"}
        for name, b in fams.items():
            assert 1 <= b.batches < per_route, (name, b.batches)

    _serve(app, body)


def test_health_503_while_reloading_and_admin_token_gate(small_index):
    calls = {"n": 0}

    def flaky_factory(step=None):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("encode OOM")
        return small_index

    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=10,
                           index_factory=flaky_factory)

    async def body(client):
        assert (await client.get("/health")).status == 200
        assert (await client.post("/admin/reload", json={})).status == 401
        r = await client.post("/admin/reload", headers={"X-Admin-Token": "nope"}, json={})
        assert r.status == 401 and calls["n"] == 0
        r = await client.post("/admin/reload", headers={"Authorization": "Bearer s3cret"},
                              json={"release_first": True})
        assert r.status == 500 and calls["n"] == 1
        r = await client.get("/health")
        assert r.status == 503 and (await r.json())["status"] == "reloading"
        r = await client.post("/admin/reload", headers={"X-Admin-Token": "s3cret"}, json={})
        assert r.status == 200 and (await client.get("/health")).status == 200

    _serve(create_app(svc, admin_token="s3cret"), body)


def test_similar_items_route_runs_off_event_loop(small_index):
    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=5)

    async def body(client):
        r = await client.post("/similar_items", json={"item_idx": [3], "k": 4})
        assert r.status == 200 and len((await r.json())["results"][0]["items"]) == 4
        assert (await client.post("/similar_items", json={"item_idx": [999]})).status == 404

    _serve(create_app(svc, coalesce=False), body)


def test_livez_always_200_and_unexpected_errors_are_json_500(small_index):
    def dead_factory(step=None):
        raise RuntimeError("encode OOM")

    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=10,
                           index_factory=dead_factory)
    svc.recommend = lambda payload: (_ for _ in ()).throw(RuntimeError("device exploded"))

    async def body(client):
        assert (await client.get("/livez")).status == 200
        r = await client.post("/recommend", json={"user_idx": [1]})
        assert r.status == 500 and (await r.json())["error"] == "internal error"
        assert (await client.post("/admin/reload", json={"release_first": True})).status == 500
        assert (await client.get("/health")).status == 503
        assert (await client.get("/livez")).status == 200

    _serve(create_app(svc, coalesce=False), body)


# --- exclusions and history -------------------------------------------------------


def test_exclude_idx_filters_results(service):
    base = service.recommend({"user_idx": [3], "k": 10})["results"][0]["item_idx"]
    out = service.recommend({"user_idx": [3], "k": 10, "exclude_idx": base[:3]})
    got = out["results"][0]["item_idx"]
    assert len(got) == 10 and not set(base[:3]) & set(got)
    assert got[:7] == base[3:]  # survivors keep their order


def test_exclude_by_external_id_and_unknown_noop(service):
    top_id = service.recommend({"user_idx": [5], "k": 5})["results"][0]["items"][0]
    out = service.recommend({"user_idx": [5], "k": 5, "exclude": [top_id, "NOT_AN_ITEM"]})
    assert top_id not in out["results"][0]["items"] and len(out["results"][0]["items"]) == 5


def test_exclude_validation(service):
    with pytest.raises(ServingError) as e:
        service.recommend({"user_idx": [1], "exclude_idx": [999]})
    assert e.value.status == 404
    with pytest.raises(ServingError):
        service.recommend({"user_idx": [1], "exclude_idx": ["x"]})
    svc = RecommendService(service.index, service.vocab, default_k=5, max_exclude=2)
    with pytest.raises(ServingError, match="max_exclude"):
        svc.recommend({"user_idx": [1], "exclude_idx": [1, 2, 3]})


def test_search_depth_buckets_and_warm_depths(small_index):
    sd = RecommendService.search_depth
    assert (sd(10, 0, 1000), sd(10, 1, 1000), sd(10, 30, 1000)) == (10, 16, 64)
    assert sd(100, 200, 100000) == 512 and sd(10, 5, 12) == 12
    svc = RecommendService(small_index, None, max_exclude=40, max_history=16)
    n = small_index.num_items
    for route, cap in (("recommend", 40), ("similar_items", 0), ("recommend_by_history", 56)):
        grid = set(svc.warm_depths(route, 10, n))
        for e in range(cap + 1):
            assert svc.search_depth(10, e, n) in grid, (route, e)


def test_history_matches_index_pooling(service, small_index):
    hist = [3, 7, 9]
    got = service.recommend_by_history({"history_idx": hist, "k": 8})["results"][0]["item_idx"]
    assert len(got) == 8 and not set(hist) & set(got)  # exclude_seen defaults on
    raw = service.recommend_by_history({"history_idx": hist, "k": 8, "exclude_seen": False})
    _, idx = small_index.recommend_by_history(np.array([hist + [-1]]), 8)
    assert raw["results"][0]["item_idx"] == idx[0].tolist()


def test_history_batch_and_external_ids(service):
    out = service.recommend_by_history({"history_idx": [[1, 2], [4, 5, 6]], "k": 4})
    for res, seen in zip(out["results"], ([1, 2], [4, 5, 6])):
        assert len(res["item_idx"]) == 4 and not set(seen) & set(res["item_idx"])
    out = service.recommend_by_history({"history": ["I3", "NOPE", "I9"], "k": 3})
    assert len(out["results"][0]["items"]) == 3


@pytest.mark.parametrize(
    "payload,status,match",
    [({"k": 3}, 400, "history"), ({"history_idx": [999]}, 404, "range"),
     ({"history": ["NOPE"]}, 404, "known item")],
)
def test_history_validation(service, payload, status, match):
    with pytest.raises(ServingError, match=match) as e:
        service.recommend_by_history(payload)
    assert e.value.status == status


def test_history_too_long(service):
    svc = RecommendService(service.index, service.vocab, default_k=5, max_history=2)
    with pytest.raises(ServingError, match="max_history"):
        svc.recommend_by_history({"history_idx": [1, 2, 3]})


def test_history_route_and_coalesced_exclusion(small_index):
    svc = RecommendService(small_index, _FakeVocab(100, 60), default_k=6)

    async def body(client):
        r = await client.post("/recommend_by_history", json={"history_idx": [2, 8], "k": 5})
        got = (await r.json())["results"][0]["item_idx"]
        assert r.status == 200 and len(got) == 5 and not {2, 8} & set(got)
        base = await (await client.post("/recommend", json={"user_idx": [7], "k": 6})).json()
        top = base["results"][0]["item_idx"][:2]
        r = await client.post("/recommend", json={"user_idx": [7], "k": 6, "exclude_idx": top})
        got = (await r.json())["results"][0]["item_idx"]
        assert r.status == 200 and len(got) == 6 and not set(top) & set(got)

    _serve(create_app(svc), body)

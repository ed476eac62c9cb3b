"""The port's copies of the data modules against the JAX package's: the
same arrays, bit for bit (numpy only on both sides, so no tolerance).

Also holds ``small_dataset``, the one small preprocessed dataset the port's
Trainer, Evaluator and CLI tests share."""

import functools

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.data import BatchPipeline as JaxBatchPipeline
from twotower_tpu.data import Preprocessor as JaxPreprocessor
from twotower_tpu.data import generate_interactions as jax_generate
from twotower_tpu.data.vocab import VocabPair as JaxVocabPair
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import (
    BatchPipeline,
    DevicePrefetcher,
    Preprocessor,
    VocabPair,
    generate_interactions,
    torch_put,
)

SMALL = dict(num_users=200, num_items=100, num_interactions=3000)
PREPROCESS = {
    "preprocessing.min_interactions_per_user": 2,
    "preprocessing.min_interactions_per_item": 2,
}
COLUMNS = ("user_id", "item_id", "rating", "timestamp", "user_idx", "item_idx")


@functools.cache
def small_dataset():
    """(port Preprocessor, port splits) of the shared small dataset."""
    pp = Preprocessor(Config().with_overrides(PREPROCESS).preprocessing)
    data = pp.process(generate_interactions(**SMALL))
    return pp, pp.split_data(data)


def _assert_same(a, b):
    for name in COLUMNS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


def test_generate_interactions_numpy_route_matches_jax():
    ours = generate_interactions(**SMALL, with_text=True, seed=3)
    ref = jax_generate(**SMALL, with_text=True, seed=3)
    _assert_same(ours, ref)
    np.testing.assert_array_equal(ours.text, ref.text)
    np.testing.assert_array_equal(ours.title, ref.title)


def test_synthetic_device_route_is_seeded_and_in_range():
    """Past the size threshold the draw runs on the device (here the CPU):
    its own torch generator stream, so only determinism and range are
    held, not the JAX route's values."""
    kw = dict(num_users=50, num_items=1 << 15, num_interactions=1 << 13, device="cpu")
    a = generate_interactions(**kw)
    b = generate_interactions(**kw)
    _assert_same(a, b)
    items = np.array([int(s[1:]) for s in a.item_id])
    assert items.min() >= 0 and items.max() < kw["num_items"]
    assert len(np.unique(items)) > 1000  # a draw, not one winning item


@pytest.mark.parametrize("method", ["temporal", "random"])
def test_preprocess_and_split_match_jax(method):
    over = {**PREPROCESS, "preprocessing.filtering.min_rating": 2.0}
    raw = generate_interactions(**SMALL, seed=7)
    pp = Preprocessor(Config().with_overrides(over).preprocessing)
    jpp = JaxPreprocessor(JaxConfig().with_overrides(over).preprocessing)
    ours, ref = pp.process(raw), jpp.process(raw)
    _assert_same(ours, ref)
    for a, b in zip(pp.split_data(ours, method=method), jpp.split_data(ref, method=method)):
        _assert_same(a, b)


@pytest.mark.parametrize("drop_remainder", [True, False])
def test_batch_pipeline_matches_jax(drop_remainder):
    """Two epochs, and (drop_remainder=False) a ragged zero-weight tail."""
    _, splits = small_dataset()
    kw = dict(batch_size=96, seed=5, drop_remainder=drop_remainder)
    ours, ref = BatchPipeline(splits.train, **kw), JaxBatchPipeline(splits.train, **kw)
    assert len(ours) == len(ref)
    for epoch in (0, 1):
        got, want = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    if not drop_remainder:
        assert got[-1]["weight"].min() == 0.0  # the tail is padded


def test_vocab_round_trip_and_cross_read(tmp_path):
    pp, _ = small_dataset()
    pp.vocab.save(tmp_path / "ours")
    back = VocabPair.load(tmp_path / "ours")
    theirs = JaxVocabPair.load(tmp_path / "ours")  # one format for both
    for v in (back, theirs):
        np.testing.assert_array_equal(v.users.ids, pp.vocab.users.ids)
        np.testing.assert_array_equal(v.items.counts, pp.vocab.items.counts)
    ids = pp.vocab.items.ids[:5]
    np.testing.assert_array_equal(back.items.encode(ids), np.arange(5))


def test_prefetcher_with_torch_put_on_cpu():
    _, splits = small_dataset()
    pipe = BatchPipeline(splits.train, 64, seed=1)
    got = list(DevicePrefetcher(pipe.epoch(0), torch_put("cpu")))
    want = list(pipe.epoch(0))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in b:
            assert isinstance(a[k], torch.Tensor)
            np.testing.assert_array_equal(a[k].numpy(), b[k])


def test_prefetcher_surfaces_producer_errors():
    def broken():
        yield {"user_idx": np.zeros(2, np.int32)}
        raise ValueError("bad batch")

    it = DevicePrefetcher(broken(), torch_put("cpu"))
    next(it)
    with pytest.raises(ValueError, match="bad batch"):
        next(it)

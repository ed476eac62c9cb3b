"""The port's prepared-artifact reader (``data/prepared.py``) against the JAX
package's, on the tiny artifacts of ``tests/test_prepared.py``: a raw
corpus with duplicates and a tie block across the split cut, prepared by
the JAX ``StreamingPreprocessor``. Everything is compared bit for bit: the
temporal rule's counts, each split's membership and order, the one-scan
``load_splits``, the streamed ``train_pipeline``'s batches at the same seed
and shuffle buffer, ``log_q`` and the out-of-core order statistics."""

import numpy as np
import pandas as pd
import pytest

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.data import prepared as jax_prepared
from twotower_tpu.data.streaming import StreamingPreprocessor as JaxStreamingPreprocessor
from twotower_tpu_torch.data import prepared

PREPROCESS = {
    "preprocessing.min_interactions_per_user": 2,
    "preprocessing.min_interactions_per_item": 2,
}


def make_corpus(path, n=4000, users=150, items=90, seed=11):
    """``tests/test_prepared.py``'s raw corpus: duplicates and a tie block
    over a third of the rows, across the split cut."""
    rng = np.random.default_rng(seed)
    ts = rng.integers(1_600_000_000, 1_600_000_400, n).astype(np.int64)
    ts[: n // 3] = 1_600_000_100
    pd.DataFrame({
        "user_id": np.array([f"u{i:04d}" for i in rng.integers(0, users, n)], object),
        "parent_asin": np.array([f"i{i:04d}" for i in rng.integers(0, items, n)], object),
        "rating": rng.integers(1, 6, n).astype(np.float32),
        "timestamp": ts,
    }).to_parquet(path)
    return path


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prepared")
    raw = make_corpus(tmp / "raw.parquet")
    cfg = JaxConfig().with_overrides(PREPROCESS)
    JaxStreamingPreprocessor(cfg.preprocessing, batch_rows=333).process_parquet(
        raw, tmp / "prepared")
    return tmp / "prepared"


def both(artifact, batch_rows=257):
    return (prepared.PreparedDataset(artifact, batch_rows=batch_rows),
            jax_prepared.PreparedDataset(artifact, batch_rows=batch_rows))


@pytest.mark.parametrize("split", [(0.8, 0.1), (1.0, 0.0), (0.5, 0.25)])
def test_temporal_rule_and_membership_match_jax(artifact, split):
    ours, ref = both(artifact)
    assert (ours.num_rows, ours.num_users, ours.num_items) == (
        ref.num_rows, ref.num_users, ref.num_items)
    rule, jrule = ours.temporal_rule(*split), ref.temporal_rule(*split)
    assert (rule.n_train, rule.n_val, rule.n_test) == (jrule.n_train, jrule.n_val, jrule.n_test)
    # The in-memory reference: the artifact's rows in stable timestamp order.
    got = pd.read_parquet(artifact / "combined_interactions.parquet")
    order = np.argsort(got["timestamp"].to_numpy(), kind="stable")
    cut = {"train": order[: rule.n_train],
           "val": order[rule.n_train: rule.n_train + rule.n_val],
           "test": order[rule.n_train + rule.n_val:]}
    for subset in ("train", "val", "test"):
        a, b = ours.load_split(rule, subset), ref.load_split(jrule, subset)
        assert a.keys() == b.keys()
        for c in a:
            assert a[c].dtype == b[c].dtype, c
            np.testing.assert_array_equal(a[c], b[c], err_msg=f"{subset} {c}")
        np.testing.assert_array_equal(a["user_idx"], got["user_idx"].to_numpy()[cut[subset]])


def test_load_splits_matches_jax(artifact):
    ours, ref = both(artifact, batch_rows=300)
    rule, jrule = ours.temporal_rule(0.8, 0.1), ref.temporal_rule(0.8, 0.1)
    a = ours.load_splits(rule, ("train", "val", "test"), extra_columns=("rating",))
    b = ref.load_splits(jrule, ("train", "val", "test"), extra_columns=("rating",))
    for subset in b:
        assert a[subset].keys() == b[subset].keys()
        for c in b[subset]:
            np.testing.assert_array_equal(a[subset][c], b[subset][c], err_msg=f"{subset} {c}")


@pytest.mark.parametrize("shuffle_buffer", [128, 4096])
def test_streaming_epochs_match_jax(artifact, shuffle_buffer):
    ours, ref = both(artifact, batch_rows=311)
    rule, jrule = ours.temporal_rule(0.8, 0.1), ref.temporal_rule(0.8, 0.1)
    pipe = ours.train_pipeline(rule, 64, seed=7, shuffle_buffer=shuffle_buffer)
    jpipe = ref.train_pipeline(jrule, 64, seed=7, shuffle_buffer=shuffle_buffer)
    assert len(pipe) == len(jpipe) > 0 and pipe.num_examples == jpipe.num_examples
    for epoch in (0, 1):
        a, b = list(pipe.epoch(epoch)), list(jpipe.epoch(epoch))
        assert len(a) == len(b) == len(pipe)
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"epoch {epoch} {k}")


def test_log_q_and_vocab_match_jax(artifact):
    ours, ref = both(artifact)
    np.testing.assert_array_equal(ours.log_q(), ref.log_q())
    np.testing.assert_array_equal(ours.vocab.items.frequencies, ref.vocab.items.frequencies)


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_order_statistics_match_jax(dtype):
    rng = np.random.default_rng(3)
    v = rng.integers(-1000, 1000, 5000).astype(dtype)
    if dtype is np.float64:
        v[::97] = np.nan
    keys = prepared._to_keys(v)
    np.testing.assert_array_equal(keys, jax_prepared._to_keys(v))

    def chunks():
        for start in range(0, len(keys), 700):
            yield keys[start: start + 700]

    ranks = [0, 1, 1234, 2500, 4998]
    assert prepared._keys_at_ranks(chunks, ranks) == jax_prepared._keys_at_ranks(chunks, ranks)


def test_item_tokens_wait_for_the_text_tower(artifact):
    """Without an encoder, or on an artifact without text columns, there are
    no item tokens, as in the JAX package (``test_torch_text_tower.py``
    builds them from an artifact with text)."""
    ours, ref = both(artifact)
    assert not ours.has_text and not ref.has_text
    assert ours.build_item_tokens(None) is None
    assert ours.build_item_tokens(object()) is None is ref.build_item_tokens(object())

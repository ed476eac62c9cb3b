"""The percentile over every request, the open-loop schedule, the rate over
whole calls, the spread and the id draws."""

import math

import numpy as np
import pytest
import torch

from perfbench.harness import stats
from perfbench.harness import traffic as tr


def test_percentile_nearest_rank_over_every_value():
    values = list(range(1, 101))
    assert stats.percentile(values, 99) == 99
    assert stats.percentile(values, 50) == 50
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([5.0], 99) == 5.0


def test_failed_requests_count_as_missing():
    values = [1.0] * 98 + [math.inf] * 2
    assert stats.percentile(values, 98) == 1.0
    assert stats.percentile(values, 99) == math.inf


def test_rate_is_work_over_all_the_time():
    # three whole calls of 500,000 rows ending 31.5 s after the window began
    assert stats.rate(3 * 500_000, 31.5) == pytest.approx(47_619.0476)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_is_the_interquartile_range_over_the_median():
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0
    q1, q2, q3 = __import__("statistics").quantiles([10, 11, 12, 13, 14, 15], n=4)
    assert stats.spread([10, 11, 12, 13, 14, 15]) == pytest.approx((q3 - q1) / q2)


def test_open_loop_schedule_from_the_seed():
    a = tr.poisson_arrivals(2000.0, 5.0, 2**31 + 11)
    b = tr.poisson_arrivals(2000.0, 5.0, 2**31 + 11)
    c = tr.poisson_arrivals(2000.0, 5.0, 2**31 + 12)
    assert np.array_equal(a, b)
    assert not np.array_equal(a[:100], c[:100])
    assert np.all(np.diff(a) > 0) and a[-1] < 5.0
    assert abs(len(a) - 10_000) < 5 * math.sqrt(10_000)
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1 / 2000.0, rel=0.05)
    assert np.std(gaps) == pytest.approx(1 / 2000.0, rel=0.1)  # exponential gaps


def test_zipf_ids_are_skewed_and_seeded():
    spec = {"dist": "zipf", "exponent": 1.0}
    a = tr.draw_ids(spec, 200_000, 10_000, 3_000_000_000, tr.ITEMS, "cpu")
    b = tr.draw_ids(spec, 200_000, 10_000, 3_000_000_000, tr.ITEMS, "cpu")
    assert torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 10_000
    counts = torch.bincount(a, minlength=10_000).sort(descending=True).values.double()
    # rank 1 against rank 10: about 10x under exponent 1
    assert 7 < float(counts[0] / counts[9]) < 14
    harmonic = sum(1.0 / r for r in range(1, 10_001))
    assert float(counts[0]) / 200_000 == pytest.approx(1 / harmonic, rel=0.05)


def test_same_cluster_items():
    users = tr.draw_ids({"dist": "uniform"}, 5000, 1000, 7, tr.USERS, "cpu")
    items = tr.draw_ids({"dist": "same_cluster", "clusters": 64}, 5000, 777, 7, tr.ITEMS, "cpu",
                        users=users)
    assert torch.equal(items % 64, users % 64)
    assert int(items.max()) < 777 and int(items.min()) >= 0


def test_sample_from_the_seed():
    s = tr.sample_indices(10_000, 100, 5)
    assert np.array_equal(s, tr.sample_indices(10_000, 100, 5))
    assert len(set(s.tolist())) == 100 and np.all(np.diff(s) > 0)
    assert np.array_equal(tr.sample_indices(50, 100, 5), np.arange(50))


CATALOG_DRIFT = {"dist": "catalog_drift", "clusters": 2048, "latent_dim": 16,
                 "size_concentration": 8.0, "affinity_scale": 4.0, "noise": 0.3,
                 "within_zipf": 0.8, "catalog_start_frac": 0.6, "num_eras": 12,
                 "drift_ranks_per_era": 3, "span": [0.0, 0.8], "chunks": 40}


def _repeats(items: np.ndarray, batches: int, rng) -> float:
    """Mean number of rows a batch of 8,192 whose item another row has."""
    return float(np.mean([8192 - len(np.unique(items[rng.choice(len(items), 8192, replace=False)]))
                          for _ in range(batches)]))


def test_catalog_drift_follows_the_generator():
    """The law against the repo's synthetic generator itself, at a tenth of
    config 3's users and items: the repeats in a batch of the train split's
    rows agree (the number a step's row updates and hit masks depend on)."""
    from twotower_tpu_torch.data.synthetic_scale import ClusterCatalog, _cluster_choice_np

    users_n, items_n, rows = 250_000, 120_000, 131_072
    rng = np.random.default_rng(42)
    u_lat = rng.normal(size=(users_n, 16)).astype(np.float32)
    c_lat = rng.normal(size=(2048, 16)).astype(np.float32)
    cat = ClusterCatalog(items_n, 2048, rng, 0.8)
    chunk = rng.integers(0, 40, size=rows)  # the train split: the first 40 of 50 chunks
    users = rng.integers(0, users_n, size=rows)
    clusters = np.where(rng.random(rows) < 0.3,
                        rng.choice(2048, size=rows, p=cat.cluster_sizes() / items_n),
                        _cluster_choice_np(u_lat, c_lat, users, 4.0, rng))
    made = np.empty(rows, np.int64)
    for k in np.unique(chunk):
        m = chunk == k
        t = (k + 0.5) / 50
        made[m] = cat.sample_items(clusters[m], 0.6 + 0.4 * t, min(11, int(t * 12)), 3, rng)
    drawn = tr.draw_ids(CATALOG_DRIFT, rows, items_n, 2**31 + 3, tr.ITEMS, "cpu",
                        num_users=users_n).numpy()
    assert drawn.min() >= 0 and drawn.max() < items_n
    zipf = tr.draw_ids({"dist": "zipf", "exponent": 1.0}, rows, items_n, 2**31 + 3, tr.ITEMS,
                       "cpu").numpy()
    sample = np.random.default_rng(0)
    want, got = _repeats(made, 16, sample), _repeats(drawn, 16, sample)
    assert got == pytest.approx(want, rel=0.1), (got, want)
    assert _repeats(zipf, 16, sample) > 2 * want  # Zipf 1.0 is another law


def test_catalog_drift_is_seeded():
    a = tr.draw_ids(CATALOG_DRIFT, 20_000, 50_000, 2**33 + 1, tr.ITEMS, "cpu", num_users=5_000)
    b = tr.draw_ids(CATALOG_DRIFT, 20_000, 50_000, 2**33 + 1, tr.ITEMS, "cpu", num_users=5_000)
    c = tr.draw_ids(CATALOG_DRIFT, 20_000, 50_000, 2**33 + 2, tr.ITEMS, "cpu", num_users=5_000)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("clusters, items", [(16, 1000), (2048, 1_145_145), (7, 7)])
def test_cluster_sizes_sum_to_the_items(clusters, items):
    sizes = tr.cluster_sizes(np.random.default_rng(1), clusters, items, 8.0)
    assert sizes.sum() == items and sizes.min() >= 1 and len(sizes) == clusters


def test_dropout_generator_skips_the_steps_before():
    from perfbench.reference import train_ref

    towers = {"user_tower": [{"kernel": torch.zeros(4, 6)}, {"kernel": torch.zeros(6, 3)}],
              "item_tower": [{"kernel": torch.zeros(4, 5)}, {"kernel": torch.zeros(5, 3)}]}
    fresh = torch.Generator().manual_seed(12)
    for _ in range(3):
        torch.rand((8, 6), generator=fresh)
        torch.rand((8, 5), generator=fresh)
    gen = train_ref.dropout_generator(11, 3, 8, towers, "cpu")
    assert torch.equal(torch.rand((8, 6), generator=gen), torch.rand((8, 6), generator=fresh))

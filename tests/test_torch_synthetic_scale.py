"""The port's out-of-core synthetic corpus generator
(``twotower_tpu_torch/data/synthetic_scale.py``) against the JAX package's:
the numpy sampler's parquet rows and oracle teacher arrays bit for bit, the
twins of tests/test_synthetic_scale.py's properties, and the torch cluster
sampler's law on the CPU generator."""

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.data import synthetic_scale as jax_scale
from twotower_tpu_torch.data import schema
from twotower_tpu_torch.data import synthetic_scale as scale

pq = pytest.importorskip("pyarrow.parquet")

SMALL = dict(num_interactions=30_000, num_users=500, num_items=2_000, num_clusters=16,
             latent_dim=8, chunk_rows=7_000, rows_per_file=20_000, seed=3)


@pytest.mark.parametrize("oracle", [True, False], ids=["oracle", "drift"])
def test_numpy_path_matches_jax_bit_for_bit(tmp_path, oracle):
    ref = jax_scale.generate_parquet(tmp_path / "jax", use_jax=False, oracle=oracle, **SMALL)
    ours = scale.generate_parquet(tmp_path / "port", use_device=False, oracle=oracle, **SMALL)
    assert ours["files"] == ref["files"] and len(ours["files"]) == 2
    for key in ("num_interactions", "items_touched", "rating_mean", "params"):
        assert ours[key] == ref[key], key
    for f in ref["files"]:
        assert pq.read_table(tmp_path / "port" / f).equals(pq.read_table(tmp_path / "jax" / f)), f
    assert (tmp_path / "port" / "oracle_teacher.npz").exists() == oracle
    if oracle:
        with np.load(tmp_path / "jax" / "oracle_teacher.npz") as a, \
                np.load(tmp_path / "port" / "oracle_teacher.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def _generate(tmp_path, **kw):
    params = dict(
        num_interactions=120_000,
        num_users=8_000,
        num_items=6_000,
        num_clusters=64,
        chunk_rows=25_000,
        rows_per_file=50_000,
        use_device=False,
    )
    params.update(kw)
    out = tmp_path / "corpus"
    stats = scale.generate_parquet(out, **params)
    import pandas as pd

    df = pd.concat(
        [pq.read_table(out / f).to_pandas() for f in stats["files"]],
        ignore_index=True,
    )
    return stats, df


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _generate(tmp_path_factory.mktemp("scale"))


def test_schema_contract_and_order(corpus):
    stats, df = corpus
    inter = schema.from_dataframe(df)
    assert len(inter) == stats["num_interactions"] == 120_000
    assert (np.diff(df["timestamp"].to_numpy()) >= 0).all()
    assert df["rating"].between(1, 5).all()
    assert len(stats["files"]) == 3  # 120k rows / 50k per file


def test_deterministic(tmp_path, corpus):
    _, df2 = _generate(tmp_path / "b")
    assert corpus[1].equals(df2)


def test_power_law_and_kcore_survival(corpus):
    stats, df = corpus
    counts = df["parent_asin"].value_counts().to_numpy()
    top = counts[: max(1, len(counts) // 100)].sum()
    assert top / len(df) > 0.05
    assert (counts >= 5).mean() > 0.6
    assert stats["items_touched"] <= stats["num_items"]


def test_temporal_drift(corpus):
    _, df = corpus
    n = len(df)
    head = df.iloc[: n // 4]["parent_asin"].value_counts()
    tail = df.iloc[-n // 4 :]["parent_asin"].value_counts()
    assert len(set(head.head(20).index) & set(tail.head(20).index)) < 15


def test_cluster_catalog_partition():
    cat = scale.ClusterCatalog(1000, 16, np.random.default_rng(0))
    sizes = cat.cluster_sizes()
    assert sizes.sum() == 1000
    assert (sizes >= 1).all()
    assert np.array_equal(np.sort(cat.item_of_slot), np.arange(1000))
    a = cat.alive_counts(0.5)
    b = cat.alive_counts(1.0)
    assert (b >= a).all() and (b == sizes).all()


# The 0.999 quantile of chi-square with 7 degrees of freedom (8 clusters).
CHI2_7_Q999 = 24.322


@pytest.mark.parametrize("user", [0, 1, 2])
def test_torch_sampler_follows_the_softmax(user):
    """Cluster frequencies of one user's draws on the CPU generator against
    the softmax of its logits: the chi-square statistic of 40,000 draws is
    under the 0.999 quantile of chi2(7)."""
    rng = np.random.default_rng(5)
    u_lat = rng.normal(size=(3, 4)).astype(np.float32)
    c_lat = rng.normal(size=(8, 4)).astype(np.float32)
    pick = scale._ClusterChoiceTorch(u_lat, c_lat, 1.5, seed=11, device=torch.device("cpu"))
    pick.sub = 8_192  # several sub-chunks
    draws = pick(np.full(40_000, user, np.int64))
    logits = 1.5 * (u_lat[user] @ c_lat.T).astype(np.float64) / np.sqrt(4.0)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    expected = p * len(draws)
    observed = np.bincount(draws, minlength=8)
    chi2 = float(((observed - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_7_Q999, (chi2, observed, expected)


def test_device_sampler_run_on_the_cpu(tmp_path):
    """``use_device=True`` on the CPU: the torch sampler writes the same
    schema and its own stream (it differs from the numpy path's rows)."""
    kw = dict(SMALL, num_interactions=10_000, oracle=True)
    stats = scale.generate_parquet(tmp_path / "dev", use_device=True, device="cpu", **kw)
    ref = scale.generate_parquet(tmp_path / "np", use_device=False, **kw)
    a = pq.read_table(tmp_path / "dev" / stats["files"][0])
    b = pq.read_table(tmp_path / "np" / ref["files"][0])
    assert a.schema == b.schema and a.num_rows == b.num_rows
    assert not a.equals(b)
    with np.load(tmp_path / "dev" / "oracle_teacher.npz") as t1, \
            np.load(tmp_path / "np" / "oracle_teacher.npz") as t2:
        assert np.array_equal(t1["u_lat"], t2["u_lat"])


def test_cli_writes_the_corpus(tmp_path, capsys):
    rc = scale.main(["--output-dir", str(tmp_path / "cli"), "--interactions", "5000",
                     "--users", "100", "--items", "300", "--clusters", "8",
                     "--latent-dim", "4", "--oracle", "--no-device"])
    assert rc == 0
    import json

    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["num_interactions"] == 5000 and stats["params"]["oracle"] is True
    assert (tmp_path / "cli" / "oracle_teacher.npz").exists()

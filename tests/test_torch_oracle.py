"""The port's oracle evaluation (``twotower_tpu_torch/evaluation/oracle.py``)
against the JAX package's: exact ranks equal given the same ``logp``,
``log_p_clusters`` within rtol 1e-6 (numpy softmax against
``jax.nn.softmax``), the sparse plug-in skyline equal to the dense one, the
metrics' formulas, and the CLI's JSON against the JAX CLI's on one tiny
prepared artifact (metrics within 1e-6). Plus the twins of
tests/test_oracle.py's properties of the teacher."""

import contextlib
import io
import json

import numpy as np
import pytest

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.evaluation import oracle as jax_oracle
from twotower_tpu_torch.data import synthetic_scale as scale
from twotower_tpu_torch.evaluation import oracle

pq = pytest.importorskip("pyarrow.parquet")


@pytest.fixture(scope="module")
def oracle_corpus(tmp_path_factory):
    out = tmp_path_factory.mktemp("oracle_gen")
    stats = scale.generate_parquet(
        out, num_interactions=40_000, num_users=300, num_items=200, num_clusters=16,
        latent_dim=8, chunk_rows=10_000, rows_per_file=50_000, seed=7, use_device=False,
        oracle=True,
    )
    return out, stats


@pytest.fixture(scope="module")
def teachers(oracle_corpus):
    out, _ = oracle_corpus
    return (oracle.OracleTeacher(out / "oracle_teacher.npz"),
            jax_oracle.OracleTeacher(out / "oracle_teacher.npz"))


def _rows(out, stats):
    tables = [pq.read_table(out / f) for f in stats["files"]]
    users = np.concatenate([np.char.lstrip(np.asarray(t.column("user_id"), str), "U").astype(int)
                            for t in tables])
    items = np.concatenate([np.char.lstrip(np.asarray(t.column("parent_asin"), str), "I")
                            .astype(int) for t in tables])
    return users, items


def test_log_p_clusters_matches_jax(teachers):
    ours, ref = teachers
    users = np.arange(ours.num_users)
    a, b = ours.log_p_clusters(users), ref.log_p_clusters(users)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


@pytest.mark.parametrize("chunk", [None, 37])
def test_structured_ranks_equal_jax_exactly(chunk):
    """Random ``logp`` with planted ties (repeated ``log_pop`` values and
    clusters): the count and the lower-index tie order agree exactly."""
    rng = np.random.default_rng(1)
    n_items, C = 500, 12
    item_cluster = rng.integers(0, C, n_items).astype(np.int32)
    log_pop = np.round(rng.normal(size=n_items), 1).astype(np.float32)  # many ties
    table = np.round(rng.normal(size=(64, C)), 1).astype(np.float32)
    users = rng.integers(0, 64, 300)
    items = rng.integers(0, n_items, 300)
    fn = lambda u: table[u]  # noqa: E731
    ref = jax_oracle._structured_ranks(fn, item_cluster, log_pop, users, items, batch_size=128,
                                       chunk=64)
    got = oracle._structured_ranks(fn, item_cluster, log_pop, users, items, batch_size=128,
                                   chunk=chunk, device="cpu")
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


def test_exact_ranks_match_bruteforce(teachers):
    t, _ = teachers
    rng = np.random.default_rng(0)
    u = rng.integers(0, t.num_users, 64)
    i = rng.integers(0, t.num_items, 64).astype(np.int64)
    ranks = oracle.exact_ranks(t, u, i, batch_size=16, chunk=64, device="cpu")
    scores = t.item_scores(u)
    for r in range(64):
        s = scores[r]
        st = s[i[r]]
        expect = int((s > st).sum() + ((s == st) & (np.arange(len(s)) < i[r])).sum())
        assert ranks[r] == expect, r


def test_sparse_plugin_ranks_equal_jax_dense(oracle_corpus, teachers):
    out, stats = oracle_corpus
    ours, ref = teachers
    users, items = _rows(out, stats)
    tr_u, tr_i = users[:-4000], items[:-4000]
    te_u, te_i = users[-4000:], items[-4000:]
    got = oracle.plugin_ranks(ours, tr_u, tr_i, te_u, te_i, batch_size=1024, device="cpu")
    want = jax_oracle.plugin_ranks(ref, tr_u, tr_i, te_u, te_i, batch_size=1024)
    np.testing.assert_array_equal(got, want)
    # Evaluated users that never occur in train rows take the smoothed prior.
    fresh = np.full(8, ours.num_users - 1)
    keep = tr_u != ours.num_users - 1
    np.testing.assert_array_equal(
        oracle.plugin_ranks(ours, tr_u[keep], tr_i[keep], fresh, te_i[:8], device="cpu"),
        jax_oracle.plugin_ranks(ref, tr_u[keep], tr_i[keep], fresh, te_i[:8]),
    )


@pytest.mark.parametrize("cap", [None, 10])
def test_metrics_from_ranks_match_jax(cap):
    rank = np.random.default_rng(2).integers(0, 300, 1000)
    ks = (1, 5, 10, 20, 50, 100)
    assert oracle.metrics_from_ranks(rank, ks, mrr_cap=cap) == \
        jax_oracle.metrics_from_ranks(rank, ks, mrr_cap=cap)


def test_metrics_from_ranks_formulas():
    rank = np.array([0, 4, 9, 10, 250])
    m = oracle.metrics_from_ranks(rank, (1, 5, 10), mrr_cap=10)
    assert m["recall@1"] == pytest.approx(0.2)
    assert m["recall@5"] == pytest.approx(0.4)
    assert m["recall@10"] == pytest.approx(0.6)
    assert m["mrr"] == pytest.approx((1.0 + 1 / 5 + 1 / 10) / 5)


def test_helpers_match_jax():
    ids = np.array(["U00000042", "U00000000", "U00001234"])
    np.testing.assert_array_equal(oracle._vocab_to_generator_idx(ids, "U"),
                                  jax_oracle._vocab_to_generator_idx(ids, "U"))
    for n, cap in ((10, None), (10, 20), (1000, 7)):
        np.testing.assert_array_equal(oracle.strided(n, cap), jax_oracle.strided(n, cap))


def test_teacher_artifact(oracle_corpus, teachers):
    _, stats = oracle_corpus
    t, _ = teachers
    assert stats["params"]["oracle"] is True
    assert t.num_users == 300 and t.num_items == 200
    for c in range(16):
        mask = t.item_cluster == c
        np.testing.assert_allclose(np.exp(t.log_pop[mask].astype(np.float64)).sum(), 1.0,
                                   rtol=1e-5)
    np.testing.assert_allclose(t.cluster_mass.sum(), 1.0, rtol=1e-5)


def test_empirical_law_matches_teacher(oracle_corpus, teachers):
    out, stats = oracle_corpus
    t, _ = teachers
    _, items = _rows(out, stats)
    marginal = np.exp(t.item_scores(np.arange(t.num_users)).astype(np.float64)).mean(axis=0)
    marginal /= marginal.sum()
    emp = np.bincount(items, minlength=t.num_items).astype(np.float64)
    emp /= emp.sum()
    head = np.argsort(-marginal)[:20]
    np.testing.assert_allclose(emp[head], marginal[head], rtol=0.25)
    assert 0.5 * np.abs(emp - marginal).sum() < 0.15


def test_teacher_beats_random_and_plugin_approaches_it(oracle_corpus, teachers):
    out, stats = oracle_corpus
    t, _ = teachers
    users, items = _rows(out, stats)
    exact = oracle.metrics_from_ranks(
        oracle.exact_ranks(t, users[-4000:], items[-4000:], batch_size=1024, device="cpu"), (10,))
    plug = oracle.metrics_from_ranks(
        oracle.plugin_ranks(t, users[:-4000], items[:-4000], users[-4000:], items[-4000:],
                            batch_size=1024, device="cpu"), (10,))
    assert exact["recall@10"] > 5 * 10 / t.num_items
    assert plug["recall@10"] >= 0.8 * exact["recall@10"], (plug, exact)


@pytest.fixture(scope="module")
def prepared(oracle_corpus, tmp_path_factory):
    from twotower_tpu_torch.data.prepare import main as prepare_main

    out, _ = oracle_corpus
    prep = tmp_path_factory.mktemp("oracle_prep")
    with contextlib.redirect_stdout(io.StringIO()):
        assert prepare_main(["--data-dir", str(out), "--output-dir", str(prep),
                             "--streaming"]) == 0
    return out / "oracle_teacher.npz", prep


def _cli(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("subset", ["test", "val"])
def test_cli_matches_jax_cli(prepared, subset):
    teacher, prep = prepared
    argv = ["--teacher", str(teacher), "--prepared-dir", str(prep), "--subset", subset,
            "--plugin", "--batch", "512"]
    ours = _cli(oracle.main, argv + ["--device", "cpu"])
    ref = _cli(jax_oracle.main, argv)
    assert ours["rows"] == ref["rows"] > 0
    assert ours["median_rank"] == ref["median_rank"]
    assert ours["plugin_median_rank"] == ref["plugin_median_rank"]
    for key in ("metrics", "plugin_metrics"):
        assert ours[key].keys() == ref[key].keys()
        for k, v in ref[key].items():
            assert abs(ours[key][k] - v) <= 1e-6, (key, k, ours[key][k], v)


def test_cli_split_follows_config_overrides(prepared, tmp_path):
    from twotower_tpu_torch.data.prepared import PreparedDataset

    teacher, prep = prepared
    argv = ["--teacher", str(teacher), "--prepared-dir", str(prep), "--device", "cpu",
            "--subset", "test", "--out", str(tmp_path / "o.json")]
    default = _cli(oracle.main, argv)
    moved = _cli(oracle.main, argv + ["--override", "preprocessing.train_split=0.6",
                                      "preprocessing.val_split=0.1",
                                      "preprocessing.test_split=0.3"])
    rule = PreparedDataset(prep).temporal_rule(0.6, 0.1)
    assert moved["rows"] == rule.n_test != default["rows"]
    assert json.loads((tmp_path / "o.json").read_text()) == moved

"""The port's data CLIs and Amazon loader against the JAX package's, offline.

The twins of ``tests/test_features_dataflow.py`` (validator, loader,
download/explore/orchestrate) and ``tests/test_data.py``'s
``TestReferenceMigration``, with ``datasets.load_dataset`` and
``huggingface_hub.HfApi`` patched as there. Each port output is held against
the JAX package's on the same inputs: the same parquet frames, vocab arrays
and reports (``assert_same_outputs``: every file of one output directory in
the other, frames and arrays equal, JSON equal but for wall times and the
directories' own paths).
"""

import json
import pickle
import sys
from pathlib import Path
from unittest.mock import MagicMock, patch

import numpy as np
import pandas as pd
import pytest

from twotower_tpu.config import DatasetConfig as JaxDatasetConfig
from twotower_tpu.data import amazon as jax_amazon
from twotower_tpu.data import download as jax_download
from twotower_tpu.data import explore as jax_explore
from twotower_tpu.data import migrate as jax_migrate
from twotower_tpu.data import orchestrate as jax_orchestrate
from twotower_tpu_torch.config import DatasetConfig
from twotower_tpu_torch.data import amazon, download, explore, migrate, orchestrate
from twotower_tpu_torch.data.prepared import PreparedDataset
from twotower_tpu_torch.data.vocab import VocabPair, Vocabulary

LOOSE = [
    "--override",
    "preprocessing.min_interactions_per_user=2",
    "preprocessing.min_interactions_per_item=2",
    "preprocessing.filtering.min_text_length=1",
]


def _normalise(obj, root: Path):
    """JSON with wall times dropped and ``root``'s path replaced."""
    if isinstance(obj, dict):
        return {k: _normalise(v, root) for k, v in obj.items() if k != "seconds"}
    if isinstance(obj, list):
        return [_normalise(v, root) for v in obj]
    if isinstance(obj, str):
        return obj.replace(str(root), "<root>")
    return obj


def assert_same_outputs(ours: Path, ref: Path, root: Path, ref_root: Path) -> None:
    """Every file under ``ref`` is under ``ours``, with equal contents."""
    ref_files = sorted(p.relative_to(ref) for p in ref.rglob("*") if p.is_file())
    assert ref_files and ref_files == sorted(
        p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for rel in ref_files:
        a, b = ours / rel, ref / rel
        if rel.suffix == ".parquet":
            pd.testing.assert_frame_equal(pd.read_parquet(a), pd.read_parquet(b))
        elif rel.suffix == ".npz":
            with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{rel}:{k}")
        elif rel.suffix == ".json":
            assert _normalise(json.loads(a.read_text()), root) == _normalise(
                json.loads(b.read_text()), ref_root), rel
        elif rel.suffix != ".png":
            assert a.read_bytes() == b.read_bytes(), rel


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _fake_reviews_df():
    return pd.DataFrame({
        "user_id": ["u1", "u2", "u1"],
        "parent_asin": ["a1", "a2", "a2"],
        "rating": [5.0, 3.0, 4.0],
        "title": ["t1", "t2", "t3"],
        "text": ["good", "bad", "fine"],
        "timestamp": [1600000000000, 1600000010000, 1600000020000],
    })


def _rich_df(n=400, ms=False):
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "user_id": rng.choice([f"u{i}" for i in range(30)], n),
        "parent_asin": rng.choice([f"a{i}" for i in range(20)], n),
        "rating": rng.integers(1, 6, n).astype(float),
        "timestamp": rng.integers(1.5e9, 1.7e9, n) * (1000 if ms else 1),
        "text": ["some review text here ok"] * n,
        "title": ["t"] * n,
    })


def _mock_dataset(df, splits=None):
    ds = MagicMock()
    ds.__getitem__.return_value.to_pandas.return_value = df
    if splits is not None:
        ds.keys.return_value = splits
    return ds


# -- validator and loader -------------------------------------------------------


def _frame(edit):
    df = _fake_reviews_df()
    if edit == "bad_rating":
        df.loc[0, "rating"] = 9.0
    elif edit == "duplicate":
        df.loc[1, ["user_id", "parent_asin"]] = ["u1", "a1"]
    elif edit == "empty_text":
        df["text"] = ["", " ", "x"]
    elif edit == "missing_columns":
        df = pd.DataFrame({"user_id": []})
    return df


@pytest.mark.parametrize("edit", ["valid", "bad_rating", "duplicate", "empty_text",
                                  "missing_columns"])
def test_validator_matches_jax(edit):
    got = amazon.AmazonReviewsValidator().validate(_frame(edit))
    ref = jax_amazon.AmazonReviewsValidator().validate(_frame(edit))
    assert (got.ok, got.errors, got.warnings) == (ref.ok, ref.errors, ref.warnings)
    assert got.ok == (edit != "missing_columns")
    assert bool(got.warnings) == (edit in ("bad_rating", "duplicate", "empty_text"))
    meta = amazon.AmazonReviewsValidator().validate(_frame(edit), "meta")
    assert not meta.ok and meta.errors == jax_amazon.AmazonReviewsValidator().validate(
        _frame(edit), "meta").errors


def _loaders(tmp_path, **kw):
    return (amazon.AmazonReviewsLoader(DatasetConfig(cache_dir=str(tmp_path / "t"), **kw)),
            jax_amazon.AmazonReviewsLoader(JaxDatasetConfig(cache_dir=str(tmp_path / "j"), **kw)))


def test_loader_download_and_cache_match_jax(tmp_path):
    ours, ref = _loaders(tmp_path)
    with patch("datasets.load_dataset", return_value=_mock_dataset(_fake_reviews_df())) as ld:
        frames = [ours.load_category("All_Beauty"), ours.load_category("All_Beauty")]
        assert ld.call_count == 1  # the second load is a cache hit
        assert ld.call_args.args == ("McAuley-Lab/Amazon-Reviews-2023", "raw_review_All_Beauty")
        jframe = ref.load_category("All_Beauty")
    for f in frames:
        pd.testing.assert_frame_equal(f, jframe)
    assert_same_outputs(tmp_path / "t", tmp_path / "j", tmp_path / "t", tmp_path / "j")


def test_loader_sampling_is_seeded_as_jax(tmp_path):
    ours, ref = _loaders(tmp_path, seed=42)
    big = pd.concat([_fake_reviews_df()] * 10, ignore_index=True)
    with patch("datasets.load_dataset", return_value=_mock_dataset(big)):
        a = ours.load_category("X", sample_size=5)
        ja = ref.load_category("X", sample_size=5)
    b = ours.load_category("X", sample_size=5)  # from the cache
    assert a.index.tolist() == b.index.tolist() == ja.index.tolist()


def test_loader_multi_category_fault_tolerant_and_concat(tmp_path):
    def side_effect(source, config, **kw):
        if "Bad" in config:
            raise RuntimeError("network down")
        return _mock_dataset(_fake_reviews_df())

    ours, ref = _loaders(tmp_path, categories=["A", "Bad_One", "B"])
    with patch("datasets.load_dataset", side_effect=side_effect):
        assert set(ours.load_multiple_categories(["Good", "Bad_One"])) == {"Good"}
        df, jdf = ours.load(), ref.load()
    pd.testing.assert_frame_equal(df, jdf)
    assert len(df) == 6 and set(df["category"]) == {"A", "B"}


def test_loader_statistics_match_jax(tmp_path):
    ours, ref = _loaders(tmp_path)
    with patch("datasets.load_dataset", return_value=_mock_dataset(_fake_reviews_df())):
        stats = ours.get_dataset_statistics("All_Beauty")
        assert stats == ref.get_dataset_statistics("All_Beauty")
    assert (stats["num_reviews"], stats["num_users"]) == (3, 2)
    assert stats["date_range"][0].startswith("2020")


# -- download-data, explore-data ------------------------------------------------


@pytest.mark.parametrize("mode", ["kcore", "raw"])
def test_download_matches_jax(tmp_path, capsys, mode):
    extra = (["--mode", "kcore", "--combine"] if mode == "kcore"
             else ["--mode", "raw", "--with-meta", "--sample-size", "2"])
    outs = {}
    for name, main in (("t", download.main), ("j", jax_download.main)):
        ds = _mock_dataset(_fake_reviews_df(), ["train", "valid", "test"])
        with patch("datasets.load_dataset", return_value=ds):
            assert main(["--categories", "All_Beauty", "--output-dir", str(tmp_path / name),
                         "--override", f"dataset.cache_dir={tmp_path / name}_cache",
                         *extra]) == 0
        outs[name] = _last_json(capsys)
    assert outs["t"] == outs["j"]
    assert_same_outputs(tmp_path / "t", tmp_path / "j", tmp_path / "t", tmp_path / "j")
    if mode == "kcore":
        assert outs["t"]["All_Beauty"]["rows"] == 9
        assert (tmp_path / "t" / "combined_5core.parquet").exists()
    else:
        assert outs["t"]["All_Beauty"] == {"reviews": 2, "meta": 3}


def test_download_discover_matches_jax(capsys):
    info = MagicMock(siblings=[
        MagicMock(rfilename="raw/review_categories/All_Beauty.jsonl"),
        MagicMock(rfilename="raw/review_categories/Video_Games.jsonl"),
        MagicMock(rfilename="raw/meta_categories/All_Beauty.jsonl"),  # not a review category
    ])
    outs = []
    for main in (download.main, jax_download.main):
        with patch("huggingface_hub.HfApi") as api:
            api.return_value.dataset_info.return_value = info
            assert main(["--discover"]) == 0
        outs.append(_last_json(capsys))
    assert outs[0] == outs[1] == {"categories": ["All_Beauty", "Video_Games"]}


@pytest.mark.parametrize("package,argv", [("datasets", []), ("huggingface_hub", ["--discover"])])
def test_download_without_the_package_exits_naming_it(tmp_path, monkeypatch, capsys, package,
                                                      argv):
    monkeypatch.setitem(sys.modules, package, None)
    assert download.main([*argv, "--output-dir", str(tmp_path / "dl")]) == 1
    err = capsys.readouterr().err
    assert f"the {package!r} package is not installed" in err and "Traceback" not in err
    assert not (tmp_path / "dl").exists()


def _write_raw(root: Path, df=None, name="TestCat_5core.parquet") -> Path:
    raw = root / "raw"
    raw.mkdir(parents=True, exist_ok=True)
    (_rich_df() if df is None else df).to_parquet(raw / name)
    return raw


def test_explore_matches_jax(tmp_path, capsys):
    raw = _write_raw(tmp_path)
    _fake_reviews_df().to_parquet(raw / "Small_reviews.parquet")
    outs = []
    for name, main in (("t", explore.main), ("j", jax_explore.main)):
        assert main(["--data-dir", str(raw), "--output-dir", str(tmp_path / name)]) == 0
        outs.append(_last_json(capsys))
    assert outs[0] == outs[1] and [s["rows"] for s in outs[0]] == [3, 400]
    assert_same_outputs(tmp_path / "t", tmp_path / "j", tmp_path, tmp_path)
    assert explore.main(["--data-dir", str(tmp_path / "none"),
                         "--output-dir", str(tmp_path / "e")]) == 1


def test_prepare_explore_and_train_on_the_ports_artifact(tmp_path, capsys):
    """prepare-data --features then explore-data, as the JAX test; the
    artifact feeds the port's train-model (--data, on the CPU)."""
    from twotower_tpu_torch.data.prepare import main as prepare_main
    from twotower_tpu_torch.training.train import main as train_main

    raw = _write_raw(tmp_path)
    assert prepare_main(["--data-dir", str(raw), "--output-dir", str(tmp_path / "out"),
                         "--features", *LOOSE]) == 0
    df = pd.read_parquet(tmp_path / "out" / "combined_interactions.parquet")
    assert {"user_idx", "item_idx", "user_rating_mean"} <= set(df.columns) and len(df)
    assert explore.main(["--data-dir", str(raw), "--output-dir", str(tmp_path / "eda")]) == 0
    assert (tmp_path / "eda" / "eda_summary.csv").exists()
    capsys.readouterr()
    assert train_main([
        "--device", "cpu", "--data", str(tmp_path / "out" / "combined_interactions.parquet"),
        "--checkpoint-dir", str(tmp_path / "ckpt"), "--no-eval", "--writers", "jsonl",
        "--override", "training.epochs=1", "training.batch_size=32", "model.embedding_dim=16",
        "model.user_tower_dims=[16]", "model.item_tower_dims=[16]",
        "preprocessing.min_interactions_per_user=1", "preprocessing.min_interactions_per_item=1",
        "preprocessing.filtering.min_text_length=1"]) == 0
    assert _last_json(capsys)["num_items"] > 0


# -- orchestrate-pipeline --------------------------------------------------------


def _orchestrate(main, root: Path, extra=()) -> tuple[int, dict]:
    ds = _mock_dataset(_rich_df(ms=True), ["train"])
    with patch("datasets.load_dataset", return_value=ds):
        rc = main(["--raw-dir", str(root / "raw"), "--processed-dir", str(root / "proc"),
                   "--categories", "All_Beauty", "--mode", "kcore", *extra, *LOOSE,
                   f"dataset.cache_dir={root / 'cache'}"])
    return rc, json.loads((root / "proc" / "pipeline_report.json").read_text())


def test_orchestrate_full_resume_and_force_match_jax(tmp_path):
    ours, ref = tmp_path / "t", tmp_path / "j"
    for runs, extra in (("full", ()), ("resume", ()), ("force", ("--force", "--eda"))):
        rc, report = _orchestrate(orchestrate.main, ours, extra)
        jrc, jreport = _orchestrate(jax_orchestrate.main, ref, extra)
        assert rc == jrc == 0 and report["ok"]
        assert _normalise(report, ours) == _normalise(jreport, ref)
        status = {k: v["status"] for k, v in report["stages"].items()}
        if runs == "full":
            assert status == {"download": "ok", "prepare": "ok"}
        elif runs == "resume":
            assert status == {"download": "skipped", "prepare": "skipped"}
        else:
            assert status == {"download": "ok", "prepare": "ok", "eda": "ok"}
        assert_same_outputs(ours / "proc", ref / "proc", ours, ref)
    assert_same_outputs(ours / "raw", ref / "raw", ours, ref)
    df = pd.read_parquet(ours / "proc" / "combined_interactions.parquet")
    assert {"user_idx", "item_idx"} <= set(df.columns) and len(df) > 0


def test_orchestrate_skip_download_offline_matches_jax(tmp_path, capsys):
    reports = []
    for name, main in (("t", orchestrate.main), ("j", jax_orchestrate.main)):
        raw = _write_raw(tmp_path / name, _rich_df(ms=True), "Books_5core.parquet")
        assert main(["--skip-download", "--raw-dir", str(raw),
                     "--processed-dir", str(tmp_path / name / "proc"), *LOOSE]) == 0
        reports.append(_last_json(capsys))
    assert _normalise(reports[0], tmp_path / "t") == _normalise(reports[1], tmp_path / "j")
    assert reports[0]["stages"]["download"] == {"status": "skipped", "reason": "--skip-download"}
    assert_same_outputs(tmp_path / "t" / "proc", tmp_path / "j" / "proc", tmp_path / "t",
                        tmp_path / "j")


def test_orchestrate_skip_download_without_data_fails_as_jax(tmp_path, capsys):
    for name, main in (("t", orchestrate.main), ("j", jax_orchestrate.main)):
        assert main(["--skip-download", "--raw-dir", str(tmp_path / name / "empty"),
                     "--processed-dir", str(tmp_path / name / "proc")]) == 1
        report = _last_json(capsys)
        assert not report.get("ok") and report["stages"]["download"]["status"] == "failed"
    with pytest.raises(SystemExit):
        orchestrate.main(["--streaming", "--features"])


# -- migrate-reference-artifacts -------------------------------------------------


def _reference_artifacts(root: Path, sorted_ids=True, drop_user=False):
    """The reference's prepare_training_data.py outputs: the interactions
    parquet with precomputed columns and mappings.pkl (sorted uniques ->
    contiguous ints)."""
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "user_id": rng.choice([f"U{i:03d}" for i in range(20)], 200),
        "parent_asin": rng.choice([f"B{i:03d}" for i in range(10)], 200),
        "rating": rng.integers(1, 6, 200).astype(np.float64),
        "timestamp": rng.integers(1_500_000_000, 1_600_000_000, 200),
    })
    users = sorted(df["user_id"].unique())
    items = sorted(df["parent_asin"].unique())
    if not sorted_ids:
        users = users[::-1]
    user_to_idx = {u: i for i, u in enumerate(users)}
    item_to_idx = {v: i for i, v in enumerate(items)}
    df["user_idx"] = df["user_id"].map(user_to_idx)
    df["item_idx"] = df["parent_asin"].map(item_to_idx)
    root.mkdir(parents=True, exist_ok=True)
    pq = root / "combined_interactions.parquet"
    df.to_parquet(pq, index=False)
    if drop_user:  # a mapping from another preparation run
        user_to_idx = {u: i for i, u in enumerate(users[1:])}
    with open(root / "mappings.pkl", "wb") as f:
        pickle.dump({"user_to_idx": user_to_idx, "item_to_idx": item_to_idx,
                     "idx_to_user": {v: k for k, v in user_to_idx.items()},
                     "idx_to_item": {v: k for k, v in item_to_idx.items()}}, f)
    return root / "mappings.pkl", pq, df


# The six JAX cases in four runs: (artifact options, with the parquet, exit
# code). "sorted" is the JAX package's migrate-and-match and complete
# --prepared-dir cases, "unsorted" its flagged and not-prepared cases.
MIGRATE_CASES = {
    "sorted": ({}, True, 0),
    "unsorted": ({"sorted_ids": False}, True, 0),
    "mismatched": ({"drop_user": True}, True, 1),
    "no_counts": ({}, False, 0),
}


@pytest.mark.parametrize("case", list(MIGRATE_CASES))
def test_migrate_matches_jax(tmp_path, case):
    opts, with_parquet, want_rc = MIGRATE_CASES[case]
    outs = {}
    for name, main in (("t", migrate.main), ("j", jax_migrate.main)):
        mp, pq, df = _reference_artifacts(tmp_path / name / "ref", **opts)
        argv = ["--mappings", str(mp), "--output-dir", str(tmp_path / name / "out")]
        if with_parquet:
            argv += ["--interactions", str(pq)]
        assert main(argv) == want_rc
        outs[name] = tmp_path / name / "out"
    if want_rc:
        assert not outs["t"].exists() and not outs["j"].exists()
        return
    assert_same_outputs(outs["t"], outs["j"], tmp_path / "t", tmp_path / "j")
    report = json.loads((outs["t"] / "migration_report.json").read_text())
    vocab = VocabPair.load(outs["t"] / "vocab")
    sorted_ids = opts.get("sorted_ids", True)
    assert report["sorted_contiguous"] is sorted_ids
    assert report["prepared_dir_ready"] is (sorted_ids and with_parquet)
    assert (outs["t"] / "combined_interactions.parquet").exists() is report["prepared_dir_ready"]
    # The migrated vocab encodes the reference's precomputed columns.
    np.testing.assert_array_equal(vocab.users.encode(df["user_id"].to_numpy(object)),
                                  df["user_idx"].to_numpy())
    np.testing.assert_array_equal(vocab.items.encode(df["parent_asin"].to_numpy(object)),
                                  df["item_idx"].to_numpy())
    if not with_parquet:
        assert (vocab.users.counts == 0).all() and len(vocab.users) == df["user_id"].nunique()
    elif sorted_ids:
        from twotower_tpu_torch.data.schema import from_dataframe

        ours = Vocabulary.build(from_dataframe(df).user_id)
        np.testing.assert_array_equal(ours.ids.astype(str), vocab.users.ids.astype(str))
        np.testing.assert_array_equal(ours.counts, vocab.users.counts)
    if report["prepared_dir_ready"]:  # a complete --prepared-dir for the port's reader
        ds = PreparedDataset(outs["t"], batch_rows=64)
        assert (ds.num_rows, ds.num_users, ds.num_items) == (len(df), 20, 10)
        splits = ds.load_splits(ds.temporal_rule(0.8, 0.1), ("train", "val", "test"))
        assert sum(len(s["user_idx"]) for s in splits.values()) == len(df)
        assert ds.log_q().shape == (10,)

"""The port's ``StreamingPreprocessor`` (``data/streaming.py``) and its
``prepare-data`` CLI (``data/prepare.py``, with ``features/engineer.py``)
against the JAX package's: on ``tests/test_streaming.py``'s raw corpus
(duplicates, out-of-range ratings, text and title, k-core tails), each
writes the same artifact, file for file: the parquet's columns and rows,
the vocab arrays and manifests, and the dataset stats."""

import json

import numpy as np
import pandas as pd
import pytest

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.data.prepare import main as jax_prepare_main
from twotower_tpu.data.streaming import StreamingPreprocessor as JaxStreamingPreprocessor
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data.prepare import main as prepare_main
from twotower_tpu_torch.data.streaming import StreamingPreprocessor

PREPROCESS = {
    "preprocessing.min_interactions_per_user": 3,
    "preprocessing.min_interactions_per_item": 3,
}


def raw_frame(seed=7, n=3000):
    rng = np.random.default_rng(seed)
    users = np.array([f"u{i:04d}" for i in rng.integers(0, 220, n)], object)
    items = np.array([f"i{i:04d}" for i in rng.integers(0, 140, n)], object)
    users[100:130], items[100:130] = users[0:30], items[0:30]
    texts = ["short", "a perfectly reasonable review text", "x" * 2500,
             "Great product! Works well and lasts long."]
    return pd.DataFrame({
        "user_id": users,
        "parent_asin": items,
        "rating": rng.integers(0, 7, n).astype(np.float32),
        "timestamp": rng.integers(1_500_000_000, 1_700_000_000, n).astype(np.int64),
        "text": np.array([texts[k] for k in rng.integers(0, 4, n)], object),
        "title": np.array(["t " + str(i % 9) for i in range(n)], object),
    })


def assert_same_artifact(ours, ref):
    files = sorted(p.relative_to(ref).as_posix() for p in ref.rglob("*") if p.is_file())
    assert sorted(p.relative_to(ours).as_posix() for p in ours.rglob("*") if p.is_file()) == files
    assert "combined_interactions.parquet" in files
    for name in files:
        a, b = ours / name, ref / name
        if name.endswith(".parquet"):
            pd.testing.assert_frame_equal(pd.read_parquet(a), pd.read_parquet(b))
        elif name.endswith(".npz"):
            with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
                assert sorted(x.files) == sorted(y.files), name
                for k in y.files:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")
        elif name.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), name
        else:
            assert a.read_bytes() == b.read_bytes(), name


@pytest.mark.parametrize("batch_rows", [256, 100_000])
def test_process_parquet_matches_jax(tmp_path, batch_rows):
    raw = tmp_path / "raw.parquet"
    raw_frame().to_parquet(raw)
    stats = StreamingPreprocessor(
        Config().with_overrides(PREPROCESS).preprocessing, batch_rows=batch_rows
    ).process_parquet(raw, tmp_path / "ours")
    ref = JaxStreamingPreprocessor(
        JaxConfig().with_overrides(PREPROCESS).preprocessing, batch_rows=batch_rows
    ).process_parquet(raw, tmp_path / "ref")
    assert stats == ref and stats["num_interactions"] > 0
    assert_same_artifact(tmp_path / "ours", tmp_path / "ref")


@pytest.mark.parametrize("mode", [[], ["--streaming", "--batch-rows", "256"], ["--features"]],
                         ids=["in_memory", "streaming", "features"])
def test_prepare_cli_matches_jax(tmp_path, capsys, mode):
    """Two category files (one ``_reviews``, one ``_5core``): the in-memory
    path balances and combines them, the streaming path reads both."""
    data_dir = tmp_path / "raw"
    data_dir.mkdir()
    raw_frame(seed=7).to_parquet(data_dir / "books_reviews.parquet")
    raw_frame(seed=8, n=1500).to_parquet(data_dir / "music_5core.parquet")
    outs = []
    for name, main in (("ours", prepare_main), ("ref", jax_prepare_main)):
        argv = ["--data-dir", str(data_dir), "--output-dir", str(tmp_path / name),
                "--max-per-category", "2000", *mode, "--override",
                *[f"{k}={v}" for k, v in PREPROCESS.items()]]
        capsys.readouterr()
        assert main(argv) == 0
        outs.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert outs[0] == outs[1] and outs[0]["num_interactions"] > 0
    assert_same_artifact(tmp_path / "ours", tmp_path / "ref")
    if "--features" in mode:
        assert len(pd.read_parquet(tmp_path / "ours" / "combined_interactions.parquet").columns) > 10


def test_prepare_cli_streaming_refuses_features(tmp_path):
    data_dir = tmp_path / "raw"
    data_dir.mkdir()
    raw_frame(n=500).to_parquet(data_dir / "corpus.parquet")
    assert prepare_main(["--data-dir", str(data_dir), "--output-dir", str(tmp_path / "o"),
                         "--streaming", "--features"]) == 2
    assert prepare_main(["--data-dir", str(tmp_path / "empty"),
                         "--output-dir", str(tmp_path / "o")]) == 1

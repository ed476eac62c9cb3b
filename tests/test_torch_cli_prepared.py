"""The port's ``prepare-data`` -> ``train-model --prepared-dir`` ->
``evaluate-model --prepared-dir`` round trip on the CPU, and the execution
rungs (``--exec``), at the CLI tests' sizes (200 users, 100 items, 5,000
interactions, embedding 16, towers [32,16], batch 64, float32 compute,
dropout 0).

- ``--prepared-dir --exec host`` follows the trajectory of ``--data`` on the
  same rows (``data/prepared.py``'s promise: the same train order), and the
  JAX CLI's ``--prepared-dir --exec host`` run from the same initial state
  (per-epoch loss rtol 1e-4, metrics within one rank flip).
- ``--exec device-loop`` and ``--exec stream`` run and report their rung;
  ``--exec auto`` reports what ``training.rungs`` chose.
- ``evaluate-model --prepared-dir`` reproduces the summary's test metrics
  within 1e-6, and refuses an artifact whose vocab is not the checkpoint's.
"""

import json

import numpy as np
import pandas as pd
import pytest

from test_torch_bridge import jax_sparse_state, jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.training.train import main as jax_train_main
from twotower_tpu_torch import bridge
from twotower_tpu_torch.data import generate_interactions
from twotower_tpu_torch.data.prepare import main as prepare_main
from twotower_tpu_torch.evaluation.evaluate import main as eval_main
from twotower_tpu_torch.training import rungs
from twotower_tpu_torch.training.loop import Trainer
from twotower_tpu_torch.training.train import main as train_main
from twotower_tpu_torch.utils.checkpoint import CheckpointManager

OVERRIDES = [
    "training.batch_size=64", "training.epochs=2", "model.embedding_dim=16",
    "model.user_tower_dims=[32,16]", "model.item_tower_dims=[32,16]",
    "model.compute_dtype=float32", "model.dropout_rate=0.0",
    "preprocessing.min_interactions_per_user=2",
    "preprocessing.min_interactions_per_item=2",
]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The raw draw as parquet (for ``--data``) and its prepare-data
    artifact (for ``--prepared-dir``)."""
    tmp = tmp_path_factory.mktemp("prep")
    raw = generate_interactions(num_users=200, num_items=100, num_interactions=5000)
    (tmp / "raw").mkdir()
    pd.DataFrame({"user_id": raw.user_id, "parent_asin": raw.item_id, "rating": raw.rating,
                  "timestamp": raw.timestamp}).to_parquet(tmp / "raw" / "all_reviews.parquet")
    assert prepare_main(["--data-dir", str(tmp / "raw"), "--output-dir", str(tmp / "prepared"),
                         "--no-balance", "--override", *OVERRIDES[-2:]]) == 0
    return tmp / "raw" / "all_reviews.parquet", tmp / "prepared"


def _train(main, ckpt, source, *extra, device=True):
    argv = [*source, "--checkpoint-dir", str(ckpt), "--writers", "jsonl", *extra,
            "--override", *OVERRIDES]
    assert main((["--device", "cpu"] if device else []) + argv) == 0
    summary = json.loads((ckpt / "train_summary.json").read_text())
    lines = (ckpt / "metrics.jsonl").read_text().splitlines()
    return summary, [r for r in map(json.loads, lines) if "epoch" in r]


def test_prepared_host_follows_the_data_path(artifact, tmp_path):
    raw, prepared = artifact
    a, ra = _train(train_main, tmp_path / "p", ["--prepared-dir", str(prepared)], "--exec", "host")
    b, rb = _train(train_main, tmp_path / "d", ["--data", str(raw)], "--exec", "host")
    assert a["execution_rung"] == b["execution_rung"] == "host"
    assert (a["num_users"], a["num_items"], a["best_step"]) == (
        b["num_users"], b["num_items"], b["best_step"])
    np.testing.assert_allclose([r["loss"] for r in ra], [r["loss"] for r in rb], rtol=1e-6)
    for k, v in b["test"].items():
        assert a["test"][k] == pytest.approx(v, abs=1e-6), k


def test_prepared_host_matches_jax(artifact, tmp_path, monkeypatch):
    """Both CLIs from JAX's initial state (the port's Trainer handed it
    through the bridge)."""
    _, prepared = artifact
    jcfg = JaxConfig().with_overrides({
        "training.batch_size": 64, "training.epochs": 2, "model.embedding_dim": 16,
        "model.user_tower_dims": [32, 16], "model.item_tower_dims": [32, 16],
        "model.compute_dtype": "float32", "model.dropout_rate": 0.0})

    def jax_start(self, num_users, num_items):
        start = jax_state_to_numpy(jax_sparse_state(jcfg, num_users, num_items,
                                                    seed=jcfg.training.seed))
        return bridge.state_from_numpy(start, device=self.device)

    monkeypatch.setattr(Trainer, "init_state", jax_start)
    ours, ro = _train(train_main, tmp_path / "ours", ["--prepared-dir", str(prepared)],
                      "--exec", "host")
    ref, rr = _train(jax_train_main, tmp_path / "ref", ["--prepared-dir", str(prepared)],
                     "--exec", "host", device=False)
    assert ref["execution_rung"] == ours["execution_rung"] == "host"
    assert len(ro) == len(rr) == 2 and ours["best_step"] == ref["best_step"]
    np.testing.assert_allclose([r["loss"] for r in ro], [r["loss"] for r in rr], rtol=1e-4)
    val = pd.read_parquet(prepared / "combined_interactions.parquet").shape[0] // 10
    for k, v in ref["test"].items():
        assert abs(ours["test"][k] - v) <= 1.0 / val, k


@pytest.mark.parametrize("rung", ["device-loop", "stream"])
def test_forced_rungs_run_and_report(artifact, tmp_path, rung):
    _, prepared = artifact
    summary, records = _train(train_main, tmp_path / "ckpt", ["--prepared-dir", str(prepared)],
                              "--exec", rung)
    assert summary["execution_rung"] == rung.replace("-", "_")
    assert len(records) == 2 and all(np.isfinite(r["loss"]) for r in records)
    assert summary["best_val_metric"] > 0


@pytest.mark.parametrize("device_budget", [None, 1], ids=["unknown", "one_byte"])
def test_auto_reports_the_rung_rungs_chose(artifact, tmp_path, monkeypatch, device_budget):
    """On the CPU the device budget is unknown (16 GB assumed: the device
    loop); with no device memory the host loop."""
    _, prepared = artifact
    chosen = []
    orig = rungs.choose_execution_rung

    def spy(**kw):
        chosen.append(orig(**{**kw, "device_free_bytes": device_budget}))
        return chosen[-1]

    monkeypatch.setattr(rungs, "choose_execution_rung", spy)
    summary, _ = _train(train_main, tmp_path / "ckpt", ["--prepared-dir", str(prepared)])
    assert len(chosen) == 1
    assert summary["execution_rung"] == chosen[0].rung == (
        "device_loop" if device_budget is None else "host")


@pytest.fixture(scope="module")
def trained_device_loop(artifact, tmp_path_factory):
    _, prepared = artifact
    ckpt = tmp_path_factory.mktemp("dl") / "ckpt"
    summary, _ = _train(train_main, ckpt, ["--prepared-dir", str(prepared)],
                        "--exec", "device-loop")
    return ckpt, summary


@pytest.mark.parametrize("subset", ["test", "val"])
def test_evaluate_prepared_reproduces_the_summary(artifact, trained_device_loop, capsys, subset):
    _, prepared = artifact
    ckpt, summary = trained_device_loop
    capsys.readouterr()
    assert eval_main(["--device", "cpu", "--checkpoint-dir", str(ckpt), "--prepared-dir",
                      str(prepared), "--subset", subset]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["checkpoint_step"] == summary["best_step"]
    if subset == "val":
        assert out["metrics"]["recall@10"] == pytest.approx(summary["best_val_metric"], abs=1e-6)
    elif summary["best_step"] == CheckpointManager(ckpt).latest_step():
        for k, v in summary["test"].items():
            assert out["metrics"][k] == pytest.approx(v, abs=1e-6), k


def test_evaluate_prepared_refuses_another_vocab(artifact, trained_device_loop, tmp_path):
    raw, _ = artifact
    ckpt, _ = trained_device_loop
    other = tmp_path / "other"
    (tmp_path / "raw").mkdir()
    df = pd.read_parquet(raw)
    fewer_users = df[df.user_id.isin(sorted(df.user_id.unique())[:120])]
    fewer_users.to_parquet(tmp_path / "raw" / "x_reviews.parquet")
    assert prepare_main(["--data-dir", str(tmp_path / "raw"), "--output-dir", str(other),
                         "--no-balance", "--override", *OVERRIDES[-2:]]) == 0
    with pytest.raises(SystemExit, match="does not match the checkpoint vocab"):
        eval_main(["--device", "cpu", "--checkpoint-dir", str(ckpt), "--prepared-dir", str(other)])


def test_stream_with_device_loop_exits_as_jax_does(artifact, tmp_path):
    _, prepared = artifact
    argv = ["--prepared-dir", str(prepared), "--checkpoint-dir", str(tmp_path),
            "--stream-batches", "--device-loop", "--override", *OVERRIDES]
    with pytest.raises(SystemExit, match="incompatible with --device-loop") as ours:
        train_main(["--device", "cpu", *argv])
    with pytest.raises(SystemExit, match="incompatible with --device-loop") as ref:
        jax_train_main(argv)
    assert str(ours.value) == str(ref.value)


def test_prepared_rejects_random_split(artifact, tmp_path, capsys):
    _, prepared = artifact
    for main in (train_main, eval_main):
        with pytest.raises(SystemExit) as e:
            main(["--device", "cpu", "--prepared-dir", str(prepared), "--checkpoint-dir",
                  str(tmp_path), "--split", "random"])
        assert e.value.code == 2
        assert "temporal only" in capsys.readouterr().err

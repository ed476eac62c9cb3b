"""The port's ``train-model`` and ``evaluate-model`` CLIs on the CPU
(``--device cpu``) at the JAX CLI tests' sizes
(``tests/test_model_training.py``, ``tests/test_serving_checkpoint.py``):
the artifacts, the round trip (``evaluate`` reproduces the summary's test
metrics within 1e-6: the same params, data and code), ``--val-rows``,
``--no-eval``, ``--resume``, ``--data`` and the multi-GPU flags (the
prepared-dir path and the rungs: ``test_torch_cli_prepared.py``)."""

import json
import sys

import numpy as np
import pytest

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.evaluation.evaluate import main as eval_main
from twotower_tpu_torch.training.train import main as train_main
from twotower_tpu_torch.utils.checkpoint import CheckpointManager

OVERRIDES = [
    "training.batch_size=64", "model.embedding_dim=16",
    "model.user_tower_dims=[32,16]", "model.item_tower_dims=[32,16]",
    "preprocessing.min_interactions_per_user=2",
    "preprocessing.min_interactions_per_item=2",
]
DATA = ["--synthetic", "--synthetic-users", "200", "--synthetic-items", "100",
        "--synthetic-interactions", "5000"]


def _common(ckpt, *extra_overrides):
    return [*DATA, "--device", "cpu", "--checkpoint-dir", str(ckpt),
            "--override", *OVERRIDES, *extra_overrides]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("run") / "ckpt"
    assert train_main(_common(ckpt, "training.epochs=1") + ["--writers", "jsonl"]) == 0
    return ckpt


def test_train_writes_the_artifacts(trained):
    for name in ("config.json", "train_summary.json", "metrics.jsonl",
                 "vocab/item_vocab.npz", "vocab/user_vocab.json"):
        assert (trained / name).exists(), name
    summary = json.loads((trained / "train_summary.json").read_text())
    step = CheckpointManager(trained).latest_step()
    assert step == summary["best_step"] > 0
    assert (trained / f"step_{step:010d}" / "meta.json").exists()
    assert summary["test"]["recall@10"] > 0 and summary["device"] == "cpu"


@pytest.mark.parametrize("with_overrides", [True, False])
def test_evaluate_reproduces_the_summary(trained, capsys, with_overrides):
    """Without the overrides the trained shape comes from config.json."""
    args = _common(trained) if with_overrides else [
        *DATA, "--device", "cpu", "--checkpoint-dir", str(trained)]
    capsys.readouterr()
    assert eval_main(args + ["--subset", "test"]) == 0
    out = _last_json(capsys)
    summary = json.loads((trained / "train_summary.json").read_text())
    assert out["checkpoint_step"] == summary["best_step"]
    assert out["metrics"].keys() == summary["test"].keys()
    for key, val in summary["test"].items():
        assert out["metrics"][key] == pytest.approx(val, abs=1e-6), key


def test_evaluate_val_subset_matches_best_val_metric(trained, capsys):
    capsys.readouterr()
    assert eval_main(_common(trained) + ["--subset", "val"]) == 0
    summary = json.loads((trained / "train_summary.json").read_text())
    assert _last_json(capsys)["metrics"]["recall@10"] == pytest.approx(
        summary["best_val_metric"], abs=1e-6)


def test_val_rows_binds_the_capped_split(tmp_path, monkeypatch):
    bound = []
    orig = Evaluator.make_evaluate_fn

    def spy(self, user_idx, item_idx):
        bound.append(len(user_idx))
        return orig(self, user_idx, item_idx)

    monkeypatch.setattr(Evaluator, "make_evaluate_fn", spy)
    assert train_main(_common(tmp_path / "ckpt", "training.epochs=1")
                      + ["--val-rows", "64", "--writers", "stdout"]) == 0
    assert bound == [64]


def test_no_eval_summary_is_strict_json_and_saves(tmp_path):
    """Also --profile-dir: a torch.profiler trace of the run."""
    ckpt = tmp_path / "ckpt"
    assert train_main(_common(ckpt, "training.epochs=1")
                      + ["--no-eval", "--profile-dir", str(tmp_path / "prof")]) == 0
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]

    def reject_constant(name):
        raise ValueError(f"non-standard JSON constant: {name}")

    summary = json.loads((ckpt / "train_summary.json").read_text(),
                         parse_constant=reject_constant)
    assert summary["best_val_metric"] is None
    step = CheckpointManager(ckpt).latest_step()
    assert step is not None and step > 0
    meta = json.loads((ckpt / f"step_{step:010d}" / "meta.json").read_text())
    assert meta["epoch"] == 1


def test_resume_continues_from_checkpoint(tmp_path):
    """A run stopped after 2 epochs and resumed to 4 covers exactly the
    remaining epochs and keeps the global step monotonic."""
    ckpt = tmp_path / "ckpt"
    assert train_main(_common(ckpt, "training.epochs=2")) == 0
    first = json.loads((ckpt / "train_summary.json").read_text())
    saved_step = CheckpointManager(ckpt).latest_step()
    meta = json.loads((ckpt / f"step_{saved_step:010d}" / "meta.json").read_text())
    start_epoch = int(meta["epoch"])
    assert 1 <= start_epoch <= 2
    assert train_main(_common(ckpt, "training.epochs=4") + ["--resume"]) == 0
    resumed = json.loads((ckpt / "train_summary.json").read_text())
    assert resumed["epochs_run"] == 4 - start_epoch
    assert resumed["best_step"] >= saved_step
    assert resumed["best_val_metric"] >= first["best_val_metric"]


def test_data_parquet_path(tmp_path, capsys):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    from twotower_tpu_torch.data import generate_interactions

    raw = generate_interactions(num_users=200, num_items=100, num_interactions=5000)
    path = tmp_path / "interactions.parquet"
    pd.DataFrame({"user_id": raw.user_id, "parent_asin": raw.item_id,
                  "rating": raw.rating, "timestamp": raw.timestamp}).to_parquet(path)
    common = ["--data", str(path), "--device", "cpu", "--checkpoint-dir",
              str(tmp_path / "ckpt"), "--override", *OVERRIDES, "training.epochs=1"]
    assert train_main(common) == 0
    summary = json.loads((tmp_path / "ckpt" / "train_summary.json").read_text())
    capsys.readouterr()
    assert eval_main(common) == 0
    got = _last_json(capsys)["metrics"]
    np.testing.assert_allclose(got["recall@10"], summary["test"]["recall@10"], atol=1e-6)


@pytest.mark.parametrize("kind", ["tensorboard", "mlflow", "wandb"])
def test_missing_tracking_backend_raises(tmp_path, monkeypatch, kind):
    from twotower_tpu_torch.utils.tracking import build_writers

    for module in ("mlflow", "wandb", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, module, None)  # import raises ImportError
    with pytest.raises(ImportError, match="install it or drop"):
        build_writers([kind], jsonl_path=tmp_path / "m.jsonl")


@pytest.mark.parametrize(
    "flag",
    [["--shard-input"], ["--stream-batches", "--shard-input"], ["--device-loop", "--mesh"],
     ["--mesh"], ["--coordinator", "h:1"],
     ["--exec", "device-loop", "--coordinator", "h:1"]],
)
def test_unported_train_flags_exit_naming_roadmap(tmp_path, capsys, monkeypatch, flag):
    """The multi-GPU flags, once unported, are ported now (ROADMAP.md's
    Done): each reaches the run (stubbed here; ``test_torch_multiprocess.py``
    and ``test_torch_mesh.py`` run them), no message names ROADMAP.md, and
    ``--coordinator`` asks for ``--num-processes`` and ``--process-id``."""
    import twotower_tpu_torch.parallel.mesh as mesh_mod
    import twotower_tpu_torch.training.train as train_mod

    seen = []
    monkeypatch.setattr(train_mod, "run", lambda args, config: seen.append(args) or {})
    monkeypatch.setattr(mesh_mod, "initialize_multihost", lambda *a, **k: False)
    argv = ["--device", "cpu", "--checkpoint-dir", str(tmp_path), *flag]
    if "--coordinator" in flag:
        with pytest.raises(SystemExit) as e:
            train_main(argv)
        assert e.value.code != 0 and "--num-processes" in capsys.readouterr().err
        argv += ["--num-processes", "1", "--process-id", "0"]
    assert train_main(argv) == 0
    assert "ROADMAP.md" not in capsys.readouterr().err
    args = seen[-1]
    for f in flag:
        if f in ("--mesh", "--shard-input", "--device-loop", "--stream-batches"):
            assert getattr(args, f[2:].replace("-", "_")) is True, f
    assert args.coordinator == ("h:1" if "--coordinator" in flag else None)


@pytest.mark.parametrize("flag", [["--prepared-dir", "x", "--mesh"], ["--mesh"]])
def test_unported_evaluate_flags_exit_naming_roadmap(tmp_path, capsys, monkeypatch, flag):
    """``evaluate-model --mesh`` is ported: it reaches the run (stubbed;
    ``test_torch_multiprocess.py`` runs it on two processes)."""
    import twotower_tpu_torch.evaluation.evaluate as eval_mod
    import twotower_tpu_torch.parallel.mesh as mesh_mod

    seen = []
    monkeypatch.setattr(eval_mod, "run", lambda args, config: seen.append(args) or {})
    monkeypatch.setattr(mesh_mod, "initialize_multihost", lambda *a, **k: False)
    assert eval_main(["--device", "cpu", "--checkpoint-dir", str(tmp_path), *flag]) == 0
    assert "ROADMAP.md" not in capsys.readouterr().err
    assert seen[-1].mesh is True

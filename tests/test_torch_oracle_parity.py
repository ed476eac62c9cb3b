"""The port's oracle-parity pipeline (``twotower_tpu_torch/tools/
oracle_parity.py``) end to end on the CPU at a tiny size: the five stages
as subprocesses of the port's modules, the report's fields, and the
ceiling stage equal to the oracle CLI run on the same artifact."""

import contextlib
import io
import json

import pytest

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from twotower_tpu_torch.tools import oracle_parity

TINY = dict(
    rows=12_000, users=150, items=600, clusters=8, latent=8, zipf=0.5,
    model=["model.embedding_dim=16", "model.user_tower_dims=[32,16]",
           "model.item_tower_dims=[32,16]", "training.batch_size=256",
           "training.patience=5", "model.compute_dtype=float32"],
    epochs=3,
)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("parity")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(oracle_parity.SCALES, "tiny", TINY)
        # One thread per stage: the suite runs in several worker processes.
        for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
            mp.setenv(var, "1")
        report = oracle_parity.run_pipeline("tiny", work, device="cpu")
    return work, report


def test_report_fields(tiny_run):
    work, report = tiny_run
    assert list(report["stages"]) == ["generate", "prepare", "ceiling", "train", "evaluate"]
    assert report["generator"]["num_interactions"] == TINY["rows"]
    assert report["artifact"]["num_users"] <= TINY["users"]
    assert all(s["seconds"] > 0 for s in report["stages"].values())
    assert report["total_seconds"] == pytest.approx(
        sum(s["seconds"] for s in report["stages"].values()))
    assert report["device"] == "cpu" and report["scale"] == "tiny"
    assert report["train"]["epochs_run"] == 3
    assert report["train"]["execution_rung"] == "device_loop"  # --exec auto, eager on the CPU
    ceiling, student = report["ceiling"], report["student"]
    assert student["rows"] == ceiling["rows"] > 0
    for key in ("recall@10", "ndcg@10", "mrr", "recall@100"):
        assert report["ceiling_fraction"][key] == pytest.approx(
            student["metrics"][key] / ceiling["metrics"][key])
        assert report["plugin_fraction"][key] == pytest.approx(
            student["metrics"][key] / ceiling["plugin_metrics"][key])
    assert (work / "gen" / "oracle_teacher.npz").exists()
    assert (work / "ckpt" / "train_summary.json").exists()


def test_ceiling_stage_equals_the_oracle_cli(tiny_run):
    from twotower_tpu_torch.evaluation import oracle

    work, report = tiny_run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert oracle.main(["--teacher", str(work / "gen" / "oracle_teacher.npz"),
                            "--prepared-dir", str(work / "prepared"), "--subset", "test",
                            "--plugin", "--device", "cpu"]) == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == report["ceiling"]


def test_stage_commands_carry_the_preset_and_the_device(tmp_path):
    stages = oracle_parity.stage_commands("config2", tmp_path, device="cuda")
    assert [s[0] for s in stages] == ["generate", "prepare", "ceiling", "train", "evaluate"]
    by_name = {name: argv for name, _, argv in stages}
    gen = by_name["generate"]
    for flag, value in (("--interactions", "1000000"), ("--users", "5000"),
                        ("--items", "100000"), ("--clusters", "64"), ("--latent-dim", "16"),
                        ("--within-zipf", "0.5"), ("--seed", "42")):
        assert gen[gen.index(flag) + 1] == value
    assert "--oracle" in gen
    for name in ("generate", "ceiling", "train", "evaluate"):
        argv = by_name[name]
        assert argv[argv.index("--device") + 1] == "cuda", name
    assert "--device" not in by_name["prepare"]  # prepare-data runs on the host
    train = by_name["train"]
    assert "training.epochs=80" in train and "model.dropout_rate=0.25" in train
    assert train[train.index("--val-rows") + 1] == "200000"
    assert "--plugin" in by_name["ceiling"] and "--streaming" in by_name["prepare"]


def test_presets_match_the_jax_benchmark():
    """The presets are the JAX benchmark's, copied as they are."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "oracle_parity.py"
    spec = importlib.util.spec_from_file_location("jax_oracle_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert oracle_parity.SCALES == mod.SCALES


def test_variants_tool_runs_each_variant(tmp_path, monkeypatch, capsys):
    """``tools/oracle_variants.py`` at the tiny preset on the CPU: one corpus
    and ceiling, then a student per variant, each with its report."""
    from twotower_tpu_torch.tools import oracle_variants

    monkeypatch.setitem(oracle_parity.SCALES, "tiny", dict(TINY, epochs=2))
    assert oracle_variants.main(["--scale", "tiny", "--device", "cpu", "--work-dir",
                                 str(tmp_path), "--variants", "base", "seed1", "plain"]) == 0
    out = capsys.readouterr().out
    for name in ("base", "seed1", "plain"):
        assert f"{name}: ceiling fraction" in out
        got = json.loads((tmp_path / "variants" / f"{name}.json").read_text())
        assert got["summary"]["epochs_run"] == 2 and len(got["epochs"]) == 2
    with pytest.raises(SystemExit, match="unknown variant"):
        oracle_variants.main(["--scale", "tiny", "--device", "cpu", "--work-dir",
                              str(tmp_path), "--variants", "nope"])

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


def test_stage_commands_for_another_seed(tmp_path):
    """``seed``: the train and evaluate stages get ``training.seed`` and their
    own checkpoint directory; the other stages stay as they are."""
    base = {name: argv for name, _, argv in oracle_parity.stage_commands(
        "config3", tmp_path, device="cuda", rows_cap=1_000_000)}
    seeded = {name: argv for name, _, argv in oracle_parity.stage_commands(
        "config3", tmp_path, device="cuda", rows_cap=1_000_000, seed=1)}
    for name in ("generate", "prepare", "ceiling"):
        assert seeded[name] == base[name], name
    for name in ("train", "evaluate"):
        argv = seeded[name]
        assert argv[argv.index("--checkpoint-dir") + 1] == str(tmp_path / "ckpt_seed1")
        assert argv[-1] == "training.seed=1"
        assert argv[:-1] == [str(tmp_path / "ckpt_seed1") if a == str(tmp_path / "ckpt") else a
                             for a in base[name]]
    evaluate = seeded["evaluate"]
    assert evaluate[evaluate.index("--rows") + 1] == "1000000"
    preset = dict(oracle_parity.SCALES["config3"], rows=10)
    assert oracle_parity.stage_commands(preset, tmp_path, device="cpu")[0][2][4] == "10"


def test_counting_runner_counts_the_train_stage_only(monkeypatch, caplog):
    """Counts set to 0 just before the train stage and read just after;
    the checkpoint manager's skip messages kept; other stages go to
    ``other``."""
    import logging

    from twotower_tpu_torch.ops import kernels

    def fake(module, argv):
        for w in kernels.WRAPPERS:
            w.launches += 7
        logging.getLogger("twotower_tpu_torch.utils.checkpoint").info(
            "async checkpoint: skipping step %d (a save is in flight; one snapshot at a time)", 5)
        return "{}"

    monkeypatch.setattr(oracle_parity, "in_process_runner", fake)
    caplog.set_level(logging.INFO, logger="twotower_tpu_torch.utils.checkpoint")
    others = []
    runner = oracle_parity.CountingRunner(other=lambda m, a: others.append(m) or "{}")
    kernels.fused_fwd.launches = 100
    runner("twotower_tpu_torch.evaluation.evaluate", [])
    runner("twotower_tpu_torch.training.train", [])
    assert others == ["twotower_tpu_torch.evaluation.evaluate"]
    assert runner.launches == {"fused_fwd": 7, "fused_bwd_du": 7, "fused_bwd_dv": 7}
    assert runner.skipped_saves == [
        "async checkpoint: skipping step 5 (a save is in flight; one snapshot at a time)"]


def test_seeds_and_counts_in_one_run(tmp_path, monkeypatch):
    """``run_pipeline`` with a ``CountingRunner`` and ``seeds=(1,)`` at the
    tiny preset: the second student's report beside the first's, each with
    its steps, launches (0: the CPU runs the plain loss), durable steps and
    the step ``best_step()`` names, which evaluate-model restored; the
    teacher's digest; the report written to ``out``."""
    monkeypatch.setitem(oracle_parity.SCALES, "tiny", dict(TINY, epochs=2))
    out = tmp_path / "report.json"
    report = oracle_parity.run_pipeline(
        "tiny", tmp_path / "work", device="cpu", seeds=(1,), out=out,
        runner=oracle_parity.CountingRunner(other=oracle_parity.in_process_runner))
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert report["teacher_sha256"] == oracle_parity.teacher_digest(
        tmp_path / "work" / "gen" / "oracle_teacher.npz")
    first, second = report, report["seeds"]["1"]
    assert list(second["stages"]) == ["train", "evaluate"]
    for rep, ckpt in ((first, "ckpt"), (second, "ckpt_seed1")):
        train = rep["train"]
        assert train["epochs_run"] == 2 and len(train["val_recall_at_10"]) == 2
        assert train["launches"] == {"fused_fwd": 0, "fused_bwd_du": 0, "fused_bwd_dv": 0}
        assert train["skipped_saves"] == [] and train["backstop_steps"] == []
        assert train["restorable_best_step"] in train["durable_steps"]
        assert rep["student"]["checkpoint_step"] == train["restorable_best_step"]
        assert (tmp_path / "work" / ckpt / "train_summary.json").exists()
        assert rep["ceiling_fraction"]["recall@10"] == pytest.approx(
            rep["student"]["metrics"]["recall@10"] / report["ceiling"]["metrics"]["recall@10"])

"""Oracle-parity run of the PyTorch port: plant a teacher, train a student,
report the student's metrics as fractions of the teacher's exact ceiling.

    python -m twotower_tpu_torch.tools.oracle_parity --scale smoke --device cpu
    python -m twotower_tpu_torch.tools.oracle_parity --scale config2   # on the card

The port's twin of ``benchmarks/oracle_parity.py``, with the same presets
and stages, each a subprocess of the port's modules but the train stage,
which runs in this process so that its fused-loss kernel launches are
counted (``CountingRunner``; stage wall-clocks recorded):

1. generate -- ``data.synthetic_scale --oracle``: sample interactions from
   a KNOWN teacher; write ``oracle_teacher.npz``.
2. prepare  -- ``data.prepare --streaming``: the out-of-core artifact
   (k-core filter, vocab, temporal order). Host only: it takes no
   ``--device``.
3. ceiling  -- ``evaluation.oracle --plugin``: the teacher's EXACT
   Recall/NDCG on the held-out split (the Bayes ceiling), and the plug-in
   skyline's.
4. train    -- ``train-model --prepared-dir`` (execution rung chosen by
   ``--exec auto``) from scratch; its launches, its skipped async saves,
   its durable steps and any end-of-fit backstop are reported.
5. evaluate -- ``evaluate-model`` exact metrics on the same split.
6. report   -- student/teacher and student/plug-in ratio per metric, as
   JSON to ``--out`` (default ``<work-dir>/oracle_parity_<scale>.json``).

``--device`` goes to every stage that takes one. ``run_pipeline`` takes a
``runner``: ``in_process_runner`` runs the stages in the caller's process,
``CountingRunner(other=...)`` the train stage in process and the others
through ``other``. ``--seeds N ...`` trains and evaluates one more student per seed
(``training.seed=N``) on the same artifact, through the train and evaluate
stages' own argv, without generating, preparing or scoring the ceiling again.

Config 3 at full depth (on the card; about 40 minutes, prepare-data's 50M
rows most of it)::

    python -m twotower_tpu_torch.tools.oracle_parity --scale config3 \
        --rows-cap 1000000 --seeds 1
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

# Corpus-shape rationale (the JAX package's presets, copied as they are):
# 1. Duplicate (user,item) pairs must be RARE: dedupe-keep-latest on a
#    resampling teacher flattens the per-user law. within_zipf=0.5 + large
#    items/cluster keeps duplicate rates low (2.9% at config2, 0.9% at
#    config3).
# 2. Draws per user must RESOLVE the teacher: ~200 deduped draws per user
#    against a 64-256-cluster mixture makes the exact-teacher ceiling
#    approachable; at 20 draws/user the finite-sample limit, not the
#    training stack, caps the fraction.
SCALES = {
    # rows, users, items, clusters, latent_dim, model overrides, epochs
    "smoke": dict(
        rows=120_000, users=1_000, items=8_000, clusters=16, latent=8,
        zipf=0.5,
        model=["model.embedding_dim=32", "model.user_tower_dims=[64,32]",
               "model.item_tower_dims=[64,32]", "training.batch_size=512",
               "training.patience=10"],
        epochs=40,
    ),
    # "1M interactions, 64-dim embeddings, batch 4096". Dropout 0.25 and
    # L2 1e-5: at ~10 observations/item the item embeddings are
    # estimation-noise-limited and regularization is the decisive lever.
    "config2": dict(
        rows=1_000_000, users=5_000, items=100_000, clusters=64, latent=16,
        zipf=0.5,
        model=["model.embedding_dim=64", "model.user_tower_dims=[256,128,64]",
               "model.item_tower_dims=[256,128,64]",
               "training.batch_size=4096", "training.patience=12",
               "model.dropout_rate=0.25", "model.l2_regularization=1e-5"],
        epochs=80,
    ),
    # "~50M interactions, 128-dim embeddings" on one device.
    "config3": dict(
        rows=50_000_000, users=250_000, items=1_200_000, clusters=256,
        latent=16, zipf=0.5,
        model=["model.embedding_dim=128",
               "training.batch_size=8192",
               "training.sparse_table_updates=true",
               "training.async_checkpoint=true",
               "model.dropout_rate=0.25",
               "model.l2_regularization=1e-5",
               "training.patience=3"],
        epochs=16,
    ),
}


def subprocess_runner(module: str, argv: list[str]) -> str:
    """Run ``python -m module argv``; returns its stdout, raises on a
    non-zero exit with the end of its stderr."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{module} exited {proc.returncode}")
    return proc.stdout


def in_process_runner(module: str, argv: list[str]) -> str:
    """Run ``module.main(argv)`` in this process; returns what it printed,
    raises on a non-zero return."""
    import contextlib
    import importlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(module).main(argv)
    if rc != 0:
        raise RuntimeError(f"{module} exited {rc}")
    return out.getvalue()


class _SkipsKept(logging.Handler):
    def __init__(self, into: list):
        super().__init__(logging.INFO)
        self.into = into

    def emit(self, record: logging.LogRecord) -> None:
        if "skipping step" in str(record.msg):
            self.into.append(record.getMessage())


class CountingRunner:
    """Runs the train stage in this process, with the fused-loss kernels'
    launch counts set to 0 just before it and read just after
    (``launches``) and the checkpoint manager's skip messages kept
    (``skipped_saves``); every other stage through ``other``."""

    def __init__(self, other=subprocess_runner):
        self.other = other
        self.launches: dict[str, int] = {}
        self.skipped_saves: list[str] = []

    def __call__(self, module: str, argv: list[str]) -> str:
        if not module.endswith(".train"):
            return self.other(module, argv)
        from twotower_tpu_torch.ops import kernels

        skips: list[str] = []
        handler = _SkipsKept(skips)
        log = logging.getLogger("twotower_tpu_torch.utils.checkpoint")
        log.addHandler(handler)
        kernels.reset_launch_counts()
        try:
            out = in_process_runner(module, argv)
        finally:
            log.removeHandler(handler)
        self.launches = {w.__name__: w.launches for w in kernels.WRAPPERS}
        self.skipped_saves = skips
        return out


def teacher_digest(npz_path: str | Path) -> str:
    """sha256 over the teacher's drawn arrays, in order: ``u_lat``,
    ``c_lat``, ``item_cluster``, ``log_pop`` (each's dtype, shape and
    bytes)."""
    import numpy as np

    h = hashlib.sha256()
    with np.load(npz_path) as z:
        for key in ("u_lat", "c_lat", "item_cluster", "log_pop"):
            a = np.ascontiguousarray(z[key])
            h.update(f"{key}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def last_json_line(out: str) -> dict:
    for line in reversed(out.strip().splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    raise ValueError("no JSON line in stage output")


def stage_commands(scale: str | dict, work: Path, *, device: str, epochs: int | None = None,
                   rows_cap: int | None = None, val_rows: int = 200_000,
                   seed: int | None = None) -> list[tuple]:
    """``(stage, module, argv)`` of the five stages, in order, for a preset's
    name or a preset (``SCALES``' form). ``seed``: the student's
    ``training.seed`` (train and evaluate), checkpoints in
    ``ckpt_seed<seed>``."""
    s = SCALES[scale] if isinstance(scale, str) else scale
    gen, prep = work / "gen", work / "prepared"
    ckpt = work / ("ckpt" if seed is None else f"ckpt_seed{seed}")
    student = [*s["model"], *([] if seed is None else [f"training.seed={seed}"])]
    cap = ["--rows", str(rows_cap)] if rows_cap else []
    dev = ["--device", device]
    return [
        ("generate", "twotower_tpu_torch.data.synthetic_scale", [
            "--oracle", "--output-dir", str(gen),
            "--interactions", str(s["rows"]), "--users", str(s["users"]),
            "--items", str(s["items"]), "--clusters", str(s["clusters"]),
            "--latent-dim", str(s["latent"]), "--within-zipf", str(s["zipf"]),
            "--seed", "42", *dev]),
        ("prepare", "twotower_tpu_torch.data.prepare", [
            "--data-dir", str(gen), "--output-dir", str(prep), "--streaming"]),
        ("ceiling", "twotower_tpu_torch.evaluation.oracle", [
            "--teacher", str(gen / "oracle_teacher.npz"), "--prepared-dir", str(prep),
            "--subset", "test", "--plugin", *dev, *cap, "--override", *s["model"]]),
        ("train", "twotower_tpu_torch.training.train", [
            "--prepared-dir", str(prep), "--checkpoint-dir", str(ckpt),
            "--val-rows", str(val_rows), *dev,
            "--override", f"training.epochs={epochs or s['epochs']}", *student]),
        ("evaluate", "twotower_tpu_torch.evaluation.evaluate", [
            "--prepared-dir", str(prep), "--checkpoint-dir", str(ckpt),
            "--subset", "test", *dev, *cap, "--override", *student]),
    ]


def student_report(train_out: str, eval_out: str, ckpt: Path, ceiling: dict, runner) -> dict:
    """One student's report: the train summary's fields, its steps and
    durable checkpoints, the step ``best_step()`` names and the one
    evaluate-model restored, its metrics and their fractions of the
    ceiling's and the plug-in's."""
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    train = last_json_line(train_out)
    student = last_json_line(eval_out)
    manager = CheckpointManager(ckpt)
    epochs = [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
              if "epoch" in r]
    durable = {s: json.loads((ckpt / f"step_{s:010d}" / "meta.json").read_text())
               for s in manager.all_steps()}
    facts = {k: train.get(k) for k in (
        "best_val_metric", "best_step", "epochs_run", "steady_examples_per_sec",
        "train_examples_per_sec", "execution_rung")}
    facts.update(
        steps=int(epochs[-1]["step"]),
        val_recall_at_10=[r.get("val/recall@10") for r in epochs],
        durable_steps=sorted(durable),
        backstop_steps=[s for s, m in durable.items() if m.get("post_starvation_final")],
        restorable_best_step=manager.best_step(),
    )
    if isinstance(runner, CountingRunner):
        facts.update(launches=runner.launches, skipped_saves=runner.skipped_saves)
    plug = ceiling.get("plugin_metrics") or {}
    ratios, plugin_ratios = {}, {}
    for k, ceil_v in ceiling["metrics"].items():
        stu_v = student["metrics"].get(k)
        if stu_v is not None and ceil_v > 0:
            ratios[k] = stu_v / ceil_v
        if stu_v is not None and plug.get(k, 0) > 0:
            plugin_ratios[k] = stu_v / plug[k]
    return {"train": facts, "student": student, "ceiling_fraction": ratios,
            "plugin_fraction": plugin_ratios}


def _timed(name: str, runner, module: str, argv: list[str], into: dict,
           label: str = "") -> str:
    print(f"=== {name}{label}: {module} {' '.join(argv)}", flush=True)
    t0 = time.perf_counter()
    out = runner(module, argv)
    into[name] = {"seconds": time.perf_counter() - t0}
    print(f"=== {name}{label}: done in {into[name]['seconds']:.1f}s", flush=True)
    return out


def run_pipeline(scale: str, work: Path, *, device: str, runner=subprocess_runner,
                 epochs: int | None = None, rows_cap: int | None = None,
                 val_rows: int = 200_000, seeds: tuple[int, ...] = (),
                 out: Path | None = None) -> dict:
    """The five stages through ``runner(module, argv) -> stdout``, then the
    report: the generator's and the artifact's stats, the teacher's digest,
    the ceiling, the student's train facts and metrics (``student_report``),
    ``ceiling_fraction`` and ``plugin_fraction`` per metric, and each
    stage's seconds; under ``seeds``, the same for one more student per
    seed, trained and evaluated on the same artifact. ``out``: where the
    report is written, after the five stages and after each seed."""
    work.mkdir(parents=True, exist_ok=True)
    results: dict = {"scale": scale, "work_dir": str(work), "device": device, "stages": {}}
    kw = dict(device=device, epochs=epochs, rows_cap=rows_cap, val_rows=val_rows)
    outputs = {name: _timed(name, runner, module, argv, results["stages"])
               for name, module, argv in stage_commands(scale, work, **kw)}
    results["generator"] = last_json_line(outputs["generate"])
    results["artifact"] = last_json_line(outputs["prepare"])
    results["teacher_sha256"] = teacher_digest(work / "gen" / "oracle_teacher.npz")
    results["ceiling"] = ceiling = last_json_line(outputs["ceiling"])
    results.update(student_report(outputs["train"], outputs["evaluate"], work / "ckpt",
                                  ceiling, runner))
    results["total_seconds"] = sum(v["seconds"] for v in results["stages"].values())
    results["seeds"] = {}
    if out is not None:
        out.write_text(json.dumps(results, indent=2))
    for seed in seeds:
        stages: dict = {}
        outs = {name: _timed(name, runner, module, argv, stages, f" (seed {seed})")
                for name, module, argv in stage_commands(scale, work, seed=seed, **kw)
                if name in ("train", "evaluate")}
        results["seeds"][str(seed)] = {
            "stages": stages,
            **student_report(outs["train"], outs["evaluate"], work / f"ckpt_seed{seed}", ceiling,
                             runner)}
        if out is not None:
            out.write_text(json.dumps(results, indent=2))
    return results


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.utils.platform import resolve_device

    ap = argparse.ArgumentParser(prog="python -m twotower_tpu_torch.tools.oracle_parity")
    ap.add_argument("--scale", choices=sorted(SCALES), default="config2")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of every stage (default cuda; there is no fallback "
                    "to the CPU)")
    ap.add_argument("--work-dir", type=str, default=None,
                    help="default build/oracle_<scale> in the repository")
    ap.add_argument("--out", type=str, default=None,
                    help="report JSON (default <work-dir>/oracle_parity_<scale>.json)")
    ap.add_argument("--rows-cap", type=int, default=None,
                    help="cap ceiling/eval rows (strided) at huge scales")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--val-rows", type=int, default=200_000)
    ap.add_argument("--seeds", type=int, nargs="*", default=[],
                    help="train and evaluate one more student per seed on the same artifact")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU: raise before any work
    work = Path(args.work_dir or REPO / "build" / f"oracle_{args.scale}")
    out = Path(args.out) if args.out else work / f"oracle_parity_{args.scale}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    results = run_pipeline(args.scale, work, device=args.device, epochs=args.epochs,
                           rows_cap=args.rows_cap, val_rows=args.val_rows,
                           runner=CountingRunner(),
                           seeds=tuple(args.seeds), out=out)
    plug = results["ceiling"].get("plugin_metrics") or {}
    print(json.dumps({
        "scale": args.scale,
        "ceiling_recall@10": results["ceiling"]["metrics"].get("recall@10"),
        "plugin_recall@10": plug.get("recall@10"),
        "student_recall@10": results["student"]["metrics"].get("recall@10"),
        "fraction_recall@10": results["ceiling_fraction"].get("recall@10"),
        "fraction_ndcg@10": results["ceiling_fraction"].get("ndcg@10"),
        "plugin_fraction_recall@10": results["plugin_fraction"].get("recall@10"),
        "seeds_fraction_recall@10": {k: v["ceiling_fraction"].get("recall@10")
                                     for k, v in results["seeds"].items()},
        "out": str(out),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

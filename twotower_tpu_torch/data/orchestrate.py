"""``orchestrate-pipeline`` CLI: one-command raw-data -> training-artifact run
(the PyTorch port's own copy of ``twotower_tpu/data/orchestrate.py``, host
only: ``python -m twotower_tpu_torch.data.orchestrate``; it composes the
port's own download-data, prepare-data and explore-data mains).

The reference README's quick start invokes
``scripts/data_processing/orchestrate_pipeline.py --config ... --sample-size
1000`` (reference: README.md:33-35), but no such script exists in its tree —
it is declared capability. This supplies it: a resumable orchestrator that
chains the download (``data/download.py``), preparation (``data/prepare.py``)
and optional EDA (``data/explore.py``) stages, skipping any stage whose
output artifacts already exist (re-run with ``--force`` to rebuild).

Each stage runs through the SAME entry point its standalone CLI uses, so
orchestration adds no second code path — it only composes argv and checks
artifacts. A JSON pipeline report (per-stage status + wall time) is written
to the processed dir and printed as the last stdout line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "orchestrate-pipeline",
        description="Run download -> prepare (-> EDA) as one resumable pipeline.",
    )
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--raw-dir", type=str, default="data/raw")
    p.add_argument("--processed-dir", type=str, default="data/processed")
    p.add_argument("--categories", nargs="*", default=None)
    p.add_argument(
        "--mode", choices=["raw", "kcore"], default="kcore",
        help="download stage mode (5-core configs by default)",
    )
    p.add_argument(
        "--sample-size", type=int, default=None,
        help="per-category row cap for the download stage "
        "(the reference quick start's --sample-size 1000)",
    )
    p.add_argument(
        "--max-per-category", type=int, default=100_000,
        help="per-category balancing cap for the prepare stage",
    )
    p.add_argument(
        "--skip-download", action="store_true",
        help="start from parquet already under --raw-dir (offline runs)",
    )
    p.add_argument(
        "--streaming", action="store_true",
        help="prepare stage runs the out-of-core streaming engine",
    )
    p.add_argument("--features", action="store_true", help="engineer features in prepare")
    p.add_argument("--eda", action="store_true", help="run the EDA stage at the end")
    p.add_argument(
        "--force", action="store_true",
        help="rebuild every stage even when its artifacts exist",
    )
    return p


def _has_parquet(directory: Path) -> bool:
    return directory.is_dir() and any(directory.glob("*.parquet"))


def _prepared(directory: Path) -> bool:
    return (directory / "combined_interactions.parquet").exists() and (
        directory / "vocab"
    ).is_dir()


def _passthrough(args: argparse.Namespace) -> list[str]:
    out: list[str] = []
    if args.config:
        out += ["--config", args.config]
    if args.override:
        out += ["--override", *args.override]
    return out


def run(args: argparse.Namespace) -> dict:
    raw_dir, processed_dir = Path(args.raw_dir), Path(args.processed_dir)
    report: dict = {"stages": {}}

    def stage(name: str, skip_reason: str | None, fn) -> bool:
        if skip_reason and not args.force:
            logger.info("stage %s: skipped (%s)", name, skip_reason)
            report["stages"][name] = {"status": "skipped", "reason": skip_reason}
            return True
        t0 = time.perf_counter()
        rc = fn()
        dt = round(time.perf_counter() - t0, 2)
        status = "ok" if rc == 0 else "failed"
        report["stages"][name] = {"status": status, "seconds": dt}
        logger.info("stage %s: %s in %.1fs", name, status, dt)
        return rc == 0

    # --- download ---------------------------------------------------------
    def _download() -> int:
        from twotower_tpu_torch.data.download import main as download_main

        argv = _passthrough(args) + [
            "--mode", args.mode, "--output-dir", str(raw_dir),
        ]
        if args.categories:
            argv += ["--categories", *args.categories]
        if args.sample_size is not None:
            if args.mode == "raw":
                argv += ["--sample-size", str(args.sample_size)]
            else:
                argv += ["--max-per-category", str(args.sample_size)]
        return download_main(argv)

    skip = None
    if args.skip_download:
        skip = "--skip-download"
    elif _has_parquet(raw_dir):
        skip = f"raw parquet already present under {raw_dir}"
    if not stage("download", skip, _download):
        return report
    if not _has_parquet(raw_dir):
        logger.error("no raw parquet under %s after download stage", raw_dir)
        report["stages"]["download"] = {
            "status": "failed", "reason": f"no parquet under {raw_dir}",
        }
        return report

    # --- prepare ----------------------------------------------------------
    def _prepare() -> int:
        from twotower_tpu_torch.data.prepare import main as prepare_main

        argv = _passthrough(args) + [
            "--data-dir", str(raw_dir), "--output-dir", str(processed_dir),
            "--max-per-category", str(args.max_per_category),
        ]
        if args.streaming:
            argv += ["--streaming"]
        if args.features:
            argv += ["--features"]
        return prepare_main(argv)

    skip = (
        f"training artifact already present under {processed_dir}"
        if _prepared(processed_dir)
        else None
    )
    if not stage("prepare", skip, _prepare):
        return report

    # --- EDA (optional) ----------------------------------------------------
    if args.eda:
        def _eda() -> int:
            from twotower_tpu_torch.data.explore import main as explore_main

            # explore-data takes no --config/--override (pure artifact scan)
            return explore_main(
                ["--data-dir", str(raw_dir),
                 "--output-dir", str(processed_dir / "eda")]
            )

        stage("eda", None, _eda)

    report["ok"] = all(
        s["status"] in ("ok", "skipped") for s in report["stages"].values()
    )
    report["artifacts"] = {
        "interactions": str(processed_dir / "combined_interactions.parquet"),
        "vocab": str(processed_dir / "vocab"),
    }
    return report


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.streaming and args.features:
        # Fail at the front door instead of mid-pipeline (prepare-data
        # rejects the combination too — see data/prepare.py).
        parser.error("--features is not supported with --streaming")
    report = run(args)
    processed_dir = Path(args.processed_dir)
    if processed_dir.is_dir():
        (processed_dir / "pipeline_report.json").write_text(
            json.dumps(report, indent=2)
        )
    print(json.dumps(report))
    return 0 if report.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

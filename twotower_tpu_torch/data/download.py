"""``download-data`` CLI: fetch Amazon Reviews categories to parquet (the
PyTorch port's own copy of ``twotower_tpu/data/download.py``, host only:
``python -m twotower_tpu_torch.data.download``; it writes the same files).

Parity with the reference's two download scripts: raw per-category reviews +
metadata (reference: scripts/data_processing/download_data.py) and the
efficient preprocessed 5-core path with per-category caps and a combined
parquet (reference: scripts/data_processing/download_efficient.py). Network
access is required at runtime (HF Hub); everything else — argument handling,
stats, combination — is testable offline with a patched loader. Without
the ``datasets`` package (``huggingface_hub`` for ``--discover``) the CLI
exits 1 with a message naming it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

from twotower_tpu_torch.config import load_config, parse_cli_overrides
from twotower_tpu_torch.data.amazon import AmazonReviewsLoader
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

# Default 5-core categories (reference: download_efficient.py:19-25).
DEFAULT_KCORE_CATEGORIES = [
    "All_Beauty", "Video_Games", "Home_and_Kitchen", "Movies_and_TV", "Electronics",
]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="download-data", description="Download Amazon Reviews 2023 categories"
    )
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--categories", nargs="*", default=None)
    p.add_argument("--output-dir", type=str, default="data/raw")
    p.add_argument("--mode", choices=["raw", "kcore"], default="kcore",
                   help="raw per-category reviews+meta, or preprocessed 5-core")
    p.add_argument("--sample-size", type=int, default=None)
    p.add_argument("--max-per-category", type=int, default=200_000,
                   help="5-core row cap per category (reference default)")
    p.add_argument("--combine", action="store_true",
                   help="also write one combined parquet with a category column")
    p.add_argument("--with-meta", action="store_true",
                   help="raw mode: also download item metadata")
    p.add_argument("--discover", action="store_true",
                   help="list the categories available on the Hub and exit "
                   "(reference: amazon_loader.py:295-320 discovery)")
    return p


def download_raw(loader: AmazonReviewsLoader, categories, out_dir: Path, args) -> dict:
    """Raw reviews (+ optional meta) per category
    (reference: download_data.py:42-88)."""
    report: dict = {}
    for category in categories:
        try:
            df = loader.load_category(category, "reviews", sample_size=args.sample_size)
            path = out_dir / f"{category}_reviews.parquet"
            df.to_parquet(path, compression="snappy")
            entry = {"reviews": len(df)}
            if args.with_meta:
                meta = loader.load_category(category, "meta")
                meta_path = out_dir / f"{category}_meta.parquet"
                meta.to_parquet(meta_path, compression="snappy")
                entry["meta"] = len(meta)
            report[category] = entry
            logger.info("downloaded %s: %s", category, entry)
        except Exception as e:  # per-category tolerance (download_data.py:141-148)
            logger.error("failed %s: %s", category, e)
            report[category] = {"error": str(e)}
    return report


def download_kcore(loader: AmazonReviewsLoader, categories, out_dir: Path, args) -> dict:
    """Preprocessed 5-core splits with caps + optional combined file
    (reference: download_efficient.py:113-202)."""
    import pandas as pd

    report: dict = {}
    frames = []
    for category in categories:
        try:
            df = loader.load_kcore(category, max_rows=args.max_per_category)
            path = out_dir / f"{category}_5core.parquet"
            df.to_parquet(path, compression="snappy")
            users = df["user_id"].nunique() if "user_id" in df else 0
            items = df["parent_asin"].nunique() if "parent_asin" in df else 0
            report[category] = {
                "rows": len(df),
                "users": int(users),
                "items": int(items),
                "sparsity": 1.0 - len(df) / max(users * items, 1),
            }
            if args.combine:
                df = df.copy()
                df["category"] = category
                frames.append(df)
            logger.info("downloaded %s 5-core: %d rows", category, len(df))
        except Exception as e:
            logger.error("failed %s: %s", category, e)
            report[category] = {"error": str(e)}
    if args.combine and frames:
        combined = pd.concat(frames, ignore_index=True)
        combined.to_parquet(out_dir / "combined_5core.parquet", compression="snappy")
        report["_combined"] = {"rows": len(combined)}
    return report


def missing_package(name: str) -> bool:
    """Whether ``name`` cannot be imported; says so on stderr if it cannot."""
    if importlib.util.find_spec(name) is not None:
        return False
    print(
        f"download-data: the {name!r} package is not installed; it is needed to "
        "fetch from the HuggingFace Hub (start from parquet already on disk, e.g. "
        "orchestrate-pipeline --skip-download)",
        file=sys.stderr,
    )
    return True


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    args = build_argparser().parse_args(argv)
    if missing_package("huggingface_hub" if args.discover else "datasets"):
        return 1
    config = load_config(args.config, parse_cli_overrides(args.override))
    if args.discover:
        loader = AmazonReviewsLoader(config.dataset)
        categories = loader.get_available_categories()
        print(json.dumps({"categories": categories}))
        return 0 if categories else 1
    categories = args.categories or (
        DEFAULT_KCORE_CATEGORIES if args.mode == "kcore" else config.dataset.categories
    )
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    loader = AmazonReviewsLoader(config.dataset)
    fn = download_kcore if args.mode == "kcore" else download_raw
    report = fn(loader, categories, out_dir, args)
    (out_dir / "download_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0 if any("error" not in v for v in report.values()) else 1


if __name__ == "__main__":
    sys.exit(main())

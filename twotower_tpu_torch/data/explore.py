"""``explore-data`` CLI: per-category EDA over downloaded parquet files (the
PyTorch port's own copy of ``twotower_tpu/data/explore.py``, host only:
``python -m twotower_tpu_torch.data.explore``; it writes the same files).

Parity with the reference's EDA script (reference:
scripts/data_processing/explore_data.py): per-category review counts, unique
users/items, rating distribution, text-length stats, CSV/JSON summary —
plus optional matplotlib/plotly chart export when those libraries exist
(import-gated; the stats path has no plotting dependency).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)


def analyze_category(path: Path) -> dict:
    """Stats for one category parquet (reference: explore_data.py:13-40)."""
    import pandas as pd

    df = pd.read_parquet(path)
    out: dict = {"file": path.name, "rows": len(df)}
    if "user_id" in df:
        out["users"] = int(df["user_id"].nunique())
    if "parent_asin" in df:
        out["items"] = int(df["parent_asin"].nunique())
    if "rating" in df:
        ratings = np.asarray(pd.to_numeric(df["rating"], errors="coerce"), np.float64)
        valid = ratings[~np.isnan(ratings)]
        out["rating_mean"] = float(valid.mean()) if len(valid) else None
        out["rating_distribution"] = {
            str(int(r)): int(c)
            for r, c in zip(*np.unique(valid.astype(np.int64), return_counts=True))
        }
    if "text" in df and len(df):
        lengths = df["text"].fillna("").astype(str).str.len()
        out["text_length"] = {
            "mean": float(lengths.mean()),
            "median": float(lengths.median()),
            "max": int(lengths.max()),
        }
    return out


def create_visualizations(summaries: list[dict], out_dir: Path) -> list[str]:
    """Optional chart export (reference: explore_data.py:43-75); returns the
    written file names, empty when matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.info("matplotlib not available; skipping charts")
        return []
    names = [s["file"].split(".")[0] for s in summaries]
    rows = [s["rows"] for s in summaries]
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(names, rows)
    ax.set_ylabel("reviews")
    ax.set_title("Reviews per category")
    plt.xticks(rotation=30, ha="right")
    fig.tight_layout()
    path = out_dir / "reviews_per_category.png"
    fig.savefig(path)
    plt.close(fig)
    return [path.name]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="explore-data", description="Dataset EDA")
    p.add_argument("--data-dir", type=str, default="data/raw")
    p.add_argument("--output-dir", type=str, default="data/eda")
    p.add_argument("--charts", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    args = build_argparser().parse_args(argv)
    data_dir = Path(args.data_dir)
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    files = sorted(data_dir.glob("*.parquet"))
    if not files:
        logger.error("no parquet files under %s", data_dir)
        return 1
    summaries = []
    for path in files:
        try:
            summaries.append(analyze_category(path))
        except Exception as e:
            logger.error("failed to analyze %s: %s", path, e)

    (out_dir / "eda_summary.json").write_text(json.dumps(summaries, indent=2))
    # CSV summary (reference: explore_data.py:116-117).
    import csv

    keys = ["file", "rows", "users", "items", "rating_mean"]
    with open(out_dir / "eda_summary.csv", "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=keys, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(summaries)
    if args.charts:
        create_visualizations(summaries, out_dir)
    print(json.dumps(summaries))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``prepare-data`` CLI: build the training artifact from raw parquet shards
(the PyTorch port's own copy of ``twotower_tpu/data/prepare.py``, host only:
``python -m twotower_tpu_torch.data.prepare``; it writes the same files).

Parity with the reference's training-data prep script
(reference: scripts/data_processing/prepare_training_data.py): glob category
parquet files (``*_reviews.parquet`` + ``*_5core.parquet``), normalize
schemas across raw/5-core sources, per-category balancing cap (default 100k,
seed 42), combine, run the full preprocessing pipeline (dedupe, k-core,
vocab), and write ``combined_interactions.parquet`` plus the vocab manifest —
npz/JSON instead of the reference's pickle (prepare_training_data.py:229-234).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from twotower_tpu_torch.config import load_config, parse_cli_overrides
from twotower_tpu_torch.data import schema
from twotower_tpu_torch.data.preprocess import Preprocessor
from twotower_tpu_torch.data.schema import Interactions
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)


def load_category_files(data_dir: Path) -> dict[str, "Interactions"]:
    """Glob per-category parquet (reference: prepare_training_data.py:25-32)."""
    import pandas as pd

    out: dict[str, Interactions] = {}
    for pattern, suffix in (("*_reviews.parquet", "_reviews"), ("*_5core.parquet", "_5core")):
        for path in sorted(data_dir.glob(pattern)):
            category = path.name.replace(suffix + ".parquet", "")
            key = category
            if key in out:
                # raw + 5-core files for the same category: keep BOTH under
                # distinct keys instead of silently overwriting the first
                key = f"{category}{suffix}"
                logger.warning(
                    "category %s present in multiple sources; keeping both "
                    "(%s)", category, key,
                )
            try:
                df = pd.read_parquet(path)
                out[key] = schema.from_dataframe(df)
                logger.info("loaded %s: %d rows", path.name, len(out[key]))
            except Exception as e:
                logger.error("failed to load %s: %s", path, e)
    return out


def combine_and_balance(
    per_category: dict[str, Interactions],
    max_per_category: int | None = 100_000,
    seed: int = 42,
) -> Interactions:
    """Cap each category then concatenate
    (reference: prepare_training_data.py:71-90)."""
    rng = np.random.default_rng(seed)
    combined: Interactions | None = None
    for category, data in sorted(per_category.items()):
        if max_per_category is not None and len(data) > max_per_category:
            sel = np.sort(rng.choice(len(data), size=max_per_category, replace=False))
            data = data.select(sel)
        data = data.with_columns(category=np.full(len(data), category, object))
        combined = data if combined is None else combined.concat(data)
        logger.info("category %s: %d rows after balancing", category, len(data))
    if combined is None:
        raise RuntimeError("no category data found")
    return combined


def analyze(data: Interactions) -> dict:
    """Dataset stats incl. sparsity (reference: prepare_training_data.py:126-157)."""
    ratings = data.rating
    return {
        "num_interactions": len(data),
        "num_users": int(data.num_users),
        "num_items": int(data.num_items),
        "sparsity": float(data.sparsity),
        "rating_mean": float(ratings.mean()) if len(data) else 0.0,
        "rating_distribution": {
            str(int(r)): int(c)
            for r, c in zip(*np.unique(ratings.astype(np.int64), return_counts=True))
        }
        if len(data)
        else {},
    }


def write_artifacts(out_dir: Path, data: Interactions, pp: Preprocessor) -> None:
    import pandas as pd

    out_dir.mkdir(parents=True, exist_ok=True)
    frame = {
        "user_id": data.user_id,
        "parent_asin": data.item_id,
        "rating": data.rating,
        "timestamp": data.timestamp,
        "user_idx": data.user_idx,
        "item_idx": data.item_idx,
    }
    if data.text is not None:
        frame["text"] = data.text
    if data.title is not None:
        frame["title"] = data.title
    for k, v in data.extra.items():
        frame[k] = v
    pd.DataFrame(frame).to_parquet(
        out_dir / "combined_interactions.parquet", compression="snappy"
    )
    assert pp.vocab is not None
    pp.vocab.save(out_dir / "vocab")
    (out_dir / "dataset_stats.json").write_text(json.dumps(analyze(data), indent=2))
    logger.info("artifacts written to %s", out_dir)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="prepare-data", description="Prepare the two-tower training artifact"
    )
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--data-dir", type=str, default="data/raw",
                   help="directory of per-category parquet files")
    p.add_argument("--output-dir", type=str, default="data/processed")
    p.add_argument("--max-per-category", type=int, default=100_000)
    p.add_argument("--no-balance", action="store_true")
    p.add_argument("--features", action="store_true",
                   help="attach engineered feature columns")
    p.add_argument(
        "--streaming", action="store_true",
        help="out-of-core pipeline (bounded row buffers; corpora larger "
        "than host RAM). Implies --no-balance; no category column.",
    )
    p.add_argument(
        "--batch-rows", type=int, default=262_144,
        help="row-buffer cap per streamed chunk (--streaming)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    args = build_argparser().parse_args(argv)
    config = load_config(args.config, parse_cli_overrides(args.override))

    if args.streaming:
        from twotower_tpu_torch.data.streaming import StreamingPreprocessor

        if args.features:
            # Refuse rather than silently drop the requested columns: the
            # streaming engine emits train-ready interaction columns only
            # (engineered features need whole-corpus aggregates).
            logger.error(
                "--features is not supported with --streaming (engineered "
                "features need whole-corpus aggregates; run the in-memory "
                "path, or engineer features on the streamed output with "
                "twotower_tpu_torch.features.engineer)"
            )
            return 2
        files = sorted(Path(args.data_dir).glob("*.parquet"))
        if not files:
            logger.error("no parquet files found under %s", args.data_dir)
            return 1
        spp = StreamingPreprocessor(
            config.preprocessing, batch_rows=args.batch_rows
        )
        stats = spp.process_parquet(files, Path(args.output_dir))
        print(json.dumps(stats))
        return 0

    per_category = load_category_files(Path(args.data_dir))
    if not per_category:
        logger.error("no parquet files found under %s", args.data_dir)
        return 1
    combined = combine_and_balance(
        per_category,
        None if args.no_balance else args.max_per_category,
        seed=config.dataset.seed,
    )
    pp = Preprocessor(config.preprocessing)
    processed = pp.process(combined)
    if args.features:
        from twotower_tpu_torch.features.engineer import FeatureEngineer

        processed = FeatureEngineer().engineer_features(processed)
    write_artifacts(Path(args.output_dir), processed, pp)
    stats = analyze(processed)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())

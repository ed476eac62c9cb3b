"""Migrate reference-produced training artifacts into this framework (the
PyTorch port's own copy of ``twotower_tpu/data/migrate.py``, host only:
``python -m twotower_tpu_torch.data.migrate``; it writes the same files).

A user of the reference runs ``prepare_training_data.py`` and ends up with
``combined_interactions.parquet`` plus a pickled ``mappings.pkl`` holding
``user_to_idx``/``item_to_idx`` and their inverses (reference:
prepare_training_data.py:217-234). This CLI converts those artifacts in
place of re-running preparation:

- reads ``mappings.pkl`` and the interactions parquet;
- verifies the mapping is the sorted-unique -> contiguous encoding both
  codebases construct (reference: prepare_training_data.py:113-123; here:
  ``data/vocab.py::Vocabulary.build``), so precomputed ``user_idx``/
  ``item_idx`` columns stay row-aligned with the embedding tables this
  framework trains;
- computes the per-id interaction counts the reference never stored (the
  vocab here doubles as the log-Q frequency table, ``ops/losses.py``);
- writes the framework's pickle-free npz/JSON vocab manifest
  (``data/vocab.py``) to the output directory.

After migration, ``train-model --data combined_interactions.parquet``
consumes the parquet directly and rebuilds the identical id spaces; the
emitted vocab manifest additionally lets serving translate external ids
without a training run.

Security note: ``pickle.load`` runs arbitrary code in the worst case. The
input here is the operator's OWN artifact produced by their reference
checkout (the reference made the same trade, flagged ``# nosec B403`` at
prepare_training_data.py:229); never point this tool at an untrusted file.
"""

from __future__ import annotations

import argparse
import json
import pickle  # nosec B403 - operator-owned artifact, see module docstring
import sys
from pathlib import Path

import numpy as np

from twotower_tpu_torch.data.vocab import Vocabulary, VocabPair
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

REQUIRED_KEYS = ("user_to_idx", "item_to_idx")


def vocabulary_from_mapping(
    to_idx: dict, counts_by_id: dict[str, int] | None = None
) -> Vocabulary:
    """Build a :class:`Vocabulary` from a reference ``*_to_idx`` dict.

    The ids array is ordered by the mapping's indices (which must be a
    dense ``0..N-1`` range); ``counts_by_id`` supplies interaction counts
    (missing ids get 0 — a mapped id may have been filtered out of the
    final parquet).
    """
    n = len(to_idx)
    idx = np.fromiter(to_idx.values(), dtype=np.int64, count=n)
    if n and (idx.min() != 0 or idx.max() != n - 1 or len(np.unique(idx)) != n):
        raise ValueError(
            "mapping indices are not a dense 0..N-1 range — not a "
            "reference-format mapping"
        )
    ids = np.empty(n, dtype=object)
    for raw, i in to_idx.items():
        ids[i] = str(raw)
    counts = np.zeros(n, dtype=np.int64)
    if counts_by_id:
        for raw, c in counts_by_id.items():
            i = to_idx.get(raw)
            if i is not None:
                counts[i] = c
    return Vocabulary(ids=ids, counts=counts)


def _value_counts(col: np.ndarray) -> dict[str, int]:
    vals, counts = np.unique(col.astype(str), return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


def migrate(
    mappings_path: Path,
    interactions_path: Path | None,
    output_dir: Path,
) -> dict:
    """Convert reference artifacts -> framework vocab manifest.

    Returns a report dict (also written as ``migration_report.json``).
    """
    with open(mappings_path, "rb") as f:
        mappings = pickle.load(f)  # nosec B301 - see module docstring
    missing = [k for k in REQUIRED_KEYS if k not in mappings]
    if missing:
        raise ValueError(f"mappings.pkl missing keys: {missing}")

    user_counts: dict[str, int] | None = None
    item_counts: dict[str, int] | None = None
    report: dict = {"mappings": str(mappings_path)}
    if interactions_path is not None:
        import pandas as pd

        df = pd.read_parquet(
            interactions_path, columns=["user_id", "parent_asin"]
        )
        user_counts = _value_counts(df["user_id"].to_numpy())
        item_counts = _value_counts(df["parent_asin"].to_numpy())
        report["interactions"] = str(interactions_path)
        report["num_interactions"] = int(len(df))
        # Consistency: every id in the parquet must be mapped (the reference
        # built the mapping FROM this parquet, so a miss means mismatched
        # artifact generations).
        unmapped_users = set(user_counts) - set(map(str, mappings["user_to_idx"]))
        unmapped_items = set(item_counts) - set(map(str, mappings["item_to_idx"]))
        if unmapped_users or unmapped_items:
            raise ValueError(
                f"parquet ids missing from mappings.pkl "
                f"({len(unmapped_users)} users, {len(unmapped_items)} items) "
                "— the artifacts are from different preparation runs"
            )
    else:
        logger.warning(
            "no --interactions parquet given: vocab counts default to 0, so "
            "log-Q correction (retrieval.logq_correction) will be degenerate "
            "until a training run rebuilds them"
        )

    users = vocabulary_from_mapping(mappings["user_to_idx"], user_counts)
    items = vocabulary_from_mapping(mappings["item_to_idx"], item_counts)

    # Both codebases encode sorted-unique -> contiguous; verify so the
    # reference's precomputed user_idx/item_idx columns stay row-aligned
    # with the tables this framework trains. A non-sorted mapping still
    # migrates (the vocab preserves ITS order) but must be flagged: train
    # re-encodes from raw ids and would disagree with the parquet columns.
    sorted_order = bool(
        np.all(users.ids[:-1] <= users.ids[1:]) if len(users.ids) > 1 else True
    ) and bool(
        np.all(items.ids[:-1] <= items.ids[1:]) if len(items.ids) > 1 else True
    )
    report["sorted_contiguous"] = sorted_order
    if not sorted_order:
        logger.warning(
            "mappings.pkl is not in sorted-id order: the migrated vocab "
            "preserves the pickle's order, but train-model re-encodes raw "
            "ids in sorted order — drop the parquet's user_idx/item_idx "
            "columns and let training rebuild them"
        )

    output_dir.mkdir(parents=True, exist_ok=True)
    VocabPair(users=users, items=items).save(output_dir / "vocab")
    report.update(
        num_users=len(users),
        num_items=len(items),
        output=str(output_dir / "vocab"),
    )

    # Make the output a COMPLETE --prepared-dir: copy the interactions
    # parquet in (PreparedDataset requires combined_interactions.parquet
    # next to the vocab manifest) and write the stats sidecar, so a
    # reference user can go migrate -> train-model --prepared-dir with no
    # manual file moves.
    if interactions_path is not None and sorted_order:
        import shutil

        dest = output_dir / "combined_interactions.parquet"
        if Path(interactions_path).resolve() != dest.resolve():
            shutil.copyfile(interactions_path, dest)
        stats = {
            "num_interactions": report["num_interactions"],
            "num_users": len(users),
            "num_items": len(items),
            "source": "migrate-reference-artifacts",
        }
        (output_dir / "dataset_stats.json").write_text(
            json.dumps(stats, indent=2)
        )
        report["prepared_dir_ready"] = True
    else:
        report["prepared_dir_ready"] = False
    (output_dir / "migration_report.json").write_text(json.dumps(report, indent=2))
    logger.info(
        "migrated reference artifacts: %d users, %d items -> %s",
        len(users), len(items), output_dir / "vocab",
    )
    return report


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="migrate-reference-artifacts",
        description="Convert reference mappings.pkl (+ interactions parquet) "
        "into this framework's pickle-free vocab manifest",
    )
    p.add_argument("--mappings", type=Path, required=True,
                   help="reference mappings.pkl (prepare_training_data.py)")
    p.add_argument("--interactions", type=Path, default=None,
                   help="combined_interactions.parquet (supplies the "
                   "interaction counts the log-Q correction needs)")
    p.add_argument("--output-dir", type=Path, default=Path("data/processed"))
    return p


def main(argv: list[str] | None = None) -> int:
    setup_logging()
    args = build_argparser().parse_args(argv)
    try:
        report = migrate(args.mappings, args.interactions, args.output_dir)
    except (ValueError, FileNotFoundError) as e:
        logger.error("migration failed: %s", e)
        return 1
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``evaluate-model`` for the PyTorch port:
``python -m twotower_tpu_torch.evaluation.evaluate``.

Counterpart of ``twotower_tpu/evaluation/evaluate.py``: restores a
checkpoint of ``train-model`` (the best-metric step unless ``--step`` pins
one), takes the held-out split (from ``--prepared-dir``'s encoded columns,
after checking the artifact's vocab sizes against the checkpoint's; or
rebuilt from ``--synthetic``/``--data`` with the SAME deterministic
preprocessing and the checkpoint's vocab), and reports Recall@K / NDCG@K /
MRR over the full corpus, encoded with the item text tokens saved beside
the checkpoint when the model has a text tower. ``--mesh`` restores into
the shards of the ``(data, model)`` mesh of ``config.mesh`` (the ranks of
the process group, a launcher's or ``--coordinator``'s, else a world of one
process) and evaluates with the corpus row-sharded over ``model``; its
metrics equal the one-device run's.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from twotower_tpu_torch.config import Config, load_config_for_checkpoint, parse_cli_overrides
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="evaluate-model",
        description="Evaluate a trained two-tower checkpoint (PyTorch port)",
    )
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to evaluate on (default cuda; there is no fallback to the CPU)",
    )
    p.add_argument("--checkpoint-dir", type=str, required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the best-metric step)")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--data", type=str, default=None, help="interactions parquet")
    src.add_argument(
        "--prepared-dir", type=str, default=None,
        help="prepare-data artifact directory: score the held-out slice of "
        "the already-encoded columns without re-running preprocessing",
    )
    src.add_argument("--synthetic", action="store_true")
    p.add_argument(
        "--batch-rows", type=int, default=1 << 20,
        help="rows per streamed parquet chunk for --prepared-dir",
    )
    p.add_argument("--synthetic-users", type=int, default=2000)
    p.add_argument("--synthetic-items", type=int, default=1000)
    p.add_argument("--synthetic-interactions", type=int, default=100_000)
    p.add_argument("--split", choices=["temporal", "random"], default="temporal")
    p.add_argument("--subset", choices=["val", "test"], default="test",
                   help="which held-out slice to score")
    p.add_argument(
        "--rows", type=int, default=None,
        help="cap scoring to a strided subsample of this many held-out rows "
        "(the stride rule of train-model --val-rows)",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="evaluate over the mesh of config.mesh: the checkpoint restored into "
        "the ranks' shards, the encoded corpus row-sharded over the model axis",
    )
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process rendezvous HOST:PORT or init URL (see train-model)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def load_item_tokens(ckpt_dir: Path):
    """The item token table ``train-model`` saved beside the checkpoint
    (``item_tokens.npz``), or None when the model has no text tower (JAX
    ``evaluate.py:69-78``)."""
    tokens_path = Path(ckpt_dir) / "item_tokens.npz"
    if not tokens_path.exists():
        return None
    with np.load(tokens_path) as tok:
        return tok["tokens"]


def _capped(user_idx, item_idx, rows: int | None):
    """Strided subsample (the rule of train-model's ``--val-rows``)."""
    from twotower_tpu_torch.training.train import strided_subsample

    if not rows:
        return user_idx, item_idx
    sel = strided_subsample(len(user_idx), rows)
    return user_idx[sel], item_idx[sel]


def restore_params(
    config: Config, ckpt_dir: Path, num_users: int, num_items: int,
    step: int | None = None, *, device=None, mesh=None,
):
    """Restore params from a checkpoint via a freshly initialized template
    on ``device``; with ``mesh``, this rank's shard of them in the mesh's
    layout (``TrainState.for_config(mesh=)``), read from the rows it holds
    only, whatever layout saved them. With no ``step``, the
    best-metric durable step is preferred over the newest one: after async
    save starvation the newest checkpoint is the post-patience final
    state."""
    import torch

    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.training.state import TrainState, make_optimizer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager
    from twotower_tpu_torch.utils.platform import resolve_device

    dev = torch.device("cpu") if mesh is not None else resolve_device(device)
    optimizer = make_optimizer(config.training)
    params = two_tower.init_params(
        torch.Generator(device=dev).manual_seed(0), config.model, num_users, num_items
    )
    template = TrainState.for_config(params, optimizer, config, mesh=mesh)
    manager = CheckpointManager(ckpt_dir)
    if step is None:
        step = manager.best_step()
        if step is not None and step != manager.latest_step():
            logger.warning(
                "restoring best-metric checkpoint step %d (latest is %d)",
                step, manager.latest_step(),
            )
    state, meta = manager.restore(template, step=step)
    if meta.get("post_starvation_final"):
        logger.warning(
            "restored checkpoint is the POST-STARVATION FINAL state, not "
            "the best epoch: the best validation (%.6g) was achieved at a "
            "step whose save was skipped; metrics from this restore will "
            "be worse than train_summary.json's best",
            meta.get("metrics", {}).get("best_val_at_stop", float("nan")),
        )
    return state.params, meta


def _prepared_subset(args, config: Config, ckpt_dir: Path):
    """``--prepared-dir``: the held-out subset's encoded columns and the
    artifact's vocab sizes, which must be the checkpoint's."""
    from twotower_tpu_torch.data.prepared import PreparedDataset
    from twotower_tpu_torch.data.vocab import VocabPair

    if args.split != "temporal":
        raise SystemExit("--prepared-dir supports the temporal split only")
    dataset = PreparedDataset(args.prepared_dir, batch_rows=args.batch_rows)
    rule = dataset.temporal_rule(
        config.preprocessing.train_split, config.preprocessing.val_split
    )
    num_users, num_items = dataset.num_users, dataset.num_items
    vocab_dir = ckpt_dir / "vocab"
    if vocab_dir.exists():
        # Checkpoint parity: the artifact's id spaces must be the ones the
        # model was trained with.
        ckpt_vocab = VocabPair.load(vocab_dir)
        if len(ckpt_vocab.users) != num_users or len(ckpt_vocab.items) != num_items:
            raise SystemExit(
                f"prepared artifact vocab ({num_users} users / {num_items} items) does "
                f"not match the checkpoint vocab ({len(ckpt_vocab.users)} / "
                f"{len(ckpt_vocab.items)}); evaluate against the artifact the model "
                "trained on"
            )
    cols = dataset.load_split(rule, args.subset)
    return cols["user_idx"], cols["item_idx"], num_users, num_items


def _in_memory_subset(args, config: Config, ckpt_dir: Path):
    """``--synthetic``/``--data``: the held-out subset rebuilt with the
    training-time preprocessing and, where saved, the checkpoint's vocab."""
    from twotower_tpu_torch.data import Preprocessor
    from twotower_tpu_torch.data.vocab import VocabPair
    from twotower_tpu_torch.training.train import load_interactions

    data = load_interactions(args)
    pp = Preprocessor(config.preprocessing)
    vocab_dir = ckpt_dir / "vocab"
    if vocab_dir.exists():
        # The training-time id spaces: mandatory for checkpoint parity.
        pp.vocab = VocabPair.load(vocab_dir)
        data = pp.basic_cleaning(data)
        data = pp.process_text(data)
        data = pp.interaction_filter.filter(data)
        data = data.with_columns(
            user_idx=pp.vocab.users.encode(data.user_id),
            item_idx=pp.vocab.items.encode(data.item_id),
        )
        known = (data.user_idx >= 0) & (data.item_idx >= 0)
        data = data.select(np.nonzero(known)[0])
    else:
        logger.warning("no vocab manifest at %s; rebuilding ids from data", vocab_dir)
        data = pp.process(data)

    splits = pp.split_data(data, method=args.split)
    subset = splits.val if args.subset == "val" else splits.test
    return subset.user_idx, subset.item_idx, len(pp.vocab.users), len(pp.vocab.items)


def run(args, config: Config) -> dict:
    from twotower_tpu_torch.evaluation import Evaluator

    ckpt_dir = Path(args.checkpoint_dir)
    subset_of = _prepared_subset if args.prepared_dir else _in_memory_subset
    user_idx, item_idx, num_users, num_items = subset_of(args, config, ckpt_dir)
    mesh = None
    if args.mesh:
        from twotower_tpu_torch.parallel import build_mesh

        mesh = build_mesh(config.mesh, device=args.device)
    params, meta = restore_params(
        config, ckpt_dir, num_users, num_items, step=args.step, device=args.device, mesh=mesh
    )
    evaluator = Evaluator(config, num_items, item_tokens=load_item_tokens(ckpt_dir),
                          device=args.device, mesh=mesh)
    eu, ei = _capped(user_idx, item_idx, getattr(args, "rows", None))
    metrics = evaluator.evaluate(params, eu, ei)
    out = {
        "subset": args.subset,
        "rows": len(eu),
        "num_items": num_items,
        "checkpoint_step": meta.get("step"),
        "metrics": metrics,
    }
    if mesh is not None:
        out["mesh"] = {"data": mesh.num_data, "model": mesh.num_model, "rank": mesh.rank,
                       "backend": mesh.backend}
    return out


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.utils.platform import resolve_device

    setup_logging()
    parser = build_argparser()
    args = parser.parse_args(argv)
    if args.prepared_dir and args.split == "random":
        parser.error(
            "--prepared-dir supports --split temporal only (the reference's "
            "temporal 80/10/10 protocol); for --split random use the "
            "in-memory --data path"
        )
    if args.coordinator is not None and (args.num_processes is None
                                         or args.process_id is None):
        parser.error("--coordinator needs --num-processes and --process-id")
    resolve_device(args.device)  # no GPU: raise before any work
    config = load_config_for_checkpoint(
        args.checkpoint_dir, args.config, parse_cli_overrides(args.override)
    )
    from twotower_tpu_torch.training.train import join_process_group

    owned = join_process_group(args)
    try:
        result = run(args, config)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

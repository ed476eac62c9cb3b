"""``train-model`` for the PyTorch port:
``python -m twotower_tpu_torch.training.train``.

Counterpart of ``twotower_tpu/training/train.py``: config -> data (the
in-memory path, ``--synthetic`` or ``--data``, which preprocesses: k-core,
vocab, split; or ``--prepared-dir``, a ``prepare-data`` artifact read
without preprocessing again) -> one of three execution rungs (``--exec``:
the host loop, the device loop with every step a CUDA graph replay, or
batches streamed from the artifact; ``auto`` lets ``training.rungs`` choose
on ``--prepared-dir`` runs) with full-corpus validation, early stopping and
checkpoints -> final artifacts (``config.json``, ``vocab/``, a checkpoint,
``train_summary.json`` with the test metrics and the rung that ran), the
same files the JAX CLI writes, and ``item_tokens.npz`` when the model has a
text tower: ``--synthetic-text`` (or text/title columns in ``--data`` or
``--prepared-dir``) with ``model.text_buckets > 0`` hashes each item's
first text into ``model.text_tokens`` n-gram ids
(``features/text_encoder.py``); with ``model.text_encoder=transformer`` a
local HF tokenizer gives the ids and its model's word embeddings the text
table's init (``features/transformer_encoder.py``). Runs on ``--device
cuda`` (the default) or ``--device cpu``.

``--mesh`` trains over the ``(data, model)`` mesh of ``config.mesh``
(``parallel/``): one process a rank, started by a launcher (``torchrun``
sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) or by hand, one process each
with ``--coordinator HOST:PORT --num-processes N --process-id I`` (the
coordinator may also be an init URL such as ``file:///shared/path``);
with neither, a world of one process. Every rank reads the same data and
feeds its data shard's rows of each batch (``--shard-input``: a streamed
rank reads only its own row groups); rank 0 writes the artifacts, and
each rank writes its own rows of each checkpoint, which restores on one
device or at any layout (``utils/checkpoint.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from twotower_tpu_torch.config import Config, load_config, parse_cli_overrides
from twotower_tpu_torch.logging_utils import get_logger, setup_logging

logger = get_logger(__name__)

def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="train-model",
        description="Train the two-tower retrieval model (PyTorch port)",
    )
    p.add_argument("--config", type=str, default=None, help="YAML config path")
    p.add_argument(
        "--override", nargs="*", default=[], metavar="KEY=VALUE",
        help="dotted config overrides, e.g. training.batch_size=4096",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device to train on (default cuda; there is no fallback to the CPU)",
    )
    src = p.add_mutually_exclusive_group()
    src.add_argument(
        "--data", type=str, default=None,
        help="raw/processed interactions parquet (re-runs preprocessing)",
    )
    src.add_argument(
        "--prepared-dir", type=str, default=None,
        help="prepare-data artifact directory (combined_interactions.parquet + "
        "vocab manifest): its encoded columns and vocab, without preprocessing again",
    )
    src.add_argument(
        "--synthetic", action="store_true",
        help="train on seeded synthetic interactions (no network needed)",
    )
    p.add_argument(
        "--stream-batches", action="store_true",
        help="with --prepared-dir: stream train batches from the parquet chunk by "
        "chunk (windowed shuffle, bounded host memory); forces the 'stream' rung",
    )
    p.add_argument(
        "--exec", choices=["auto", "host", "device-loop", "stream"],
        default="auto", dest="exec_rung",
        help="execution rung. 'auto' (default) picks, on --prepared-dir runs, the "
        "best rung the device and host memory allow (training.rungs): the device "
        "loop when the columns and the train state fit the device, else the host "
        "loop, else streaming; elsewhere it runs the host loop. --device-loop and "
        "--stream-batches force their rung",
    )
    p.add_argument(
        "--shuffle-buffer", type=int, default=None,
        help="windowed-shuffle buffer rows for --stream-batches (default 8M rows, or "
        "what 'auto' sized); the window is a quality dial on time-sorted artifacts",
    )
    p.add_argument(
        "--shard-input", action="store_true",
        help="with --stream-batches on a mesh: each rank reads only the parquet row "
        "groups holding its own batch rows instead of streaming the whole artifact",
    )
    p.add_argument(
        "--batch-rows", type=int, default=1 << 20,
        help="rows per streamed parquet chunk for --prepared-dir",
    )
    p.add_argument("--synthetic-users", type=int, default=2000)
    p.add_argument("--synthetic-items", type=int, default=1000)
    p.add_argument("--synthetic-interactions", type=int, default=100_000)
    p.add_argument(
        "--synthetic-text", action="store_true",
        help="generate text/title columns too (exercises the text tower)",
    )
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--resume", action="store_true", help="resume from latest checkpoint")
    p.add_argument(
        "--writers", nargs="*", default=["stdout", "jsonl"],
        choices=["stdout", "jsonl", "tensorboard", "mlflow", "wandb"],
    )
    p.add_argument("--split", choices=["temporal", "random"], default="temporal")
    p.add_argument("--no-eval", action="store_true", help="skip validation/early stop")
    p.add_argument(
        "--val-rows", type=int, default=None,
        help="cap per-epoch validation to a strided subsample of this many "
        "held-out rows; early stopping then tracks the subsample, while the "
        "final test metrics and evaluate-model always score the FULL split",
    )
    p.add_argument(
        "--profile-dir", type=str, default=None,
        help="write a torch.profiler trace (trace.json) of the training run",
    )
    p.add_argument(
        "--device-loop", action="store_true",
        help="device-resident epochs: the columns on the device, the permutation "
        "drawn there, every step one replay of the step captured as a CUDA graph "
        "(eager on --device cpu)",
    )
    p.add_argument(
        "--mesh", action="store_true",
        help="train over the (data x model) mesh of config.mesh: the ranks of the "
        "process group (torchrun or --coordinator), else a world of one process; "
        "composes with --device-loop",
    )
    p.add_argument(
        "--coordinator", type=str, default=None,
        help="multi-process rendezvous HOST:PORT (or an init URL such as "
        "file:///shared/path), with --num-processes and --process-id; omit for "
        "torchrun or a one-process run",
    )
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p


def strided_subsample(n: int, cap: int) -> np.ndarray:
    """Indices of an evenly-spaced size-<=cap subsample of ``range(n)``:
    deterministic and uniform over the index range, so a temporally sorted
    validation split stays temporally representative."""
    if cap >= n:
        return np.arange(n)
    return np.linspace(0, n - 1, num=cap, dtype=np.int64)


def load_interactions(args):
    from twotower_tpu_torch.data import from_dataframe, generate_interactions

    if args.synthetic or args.data is None:
        if args.data is None and not args.synthetic:
            logger.info("no --data given; defaulting to --synthetic")
        return generate_interactions(
            num_users=args.synthetic_users,
            num_items=args.synthetic_items,
            num_interactions=args.synthetic_interactions,
            with_text=getattr(args, "synthetic_text", False),
            device=getattr(args, "device", None),
        )
    import pandas as pd

    return from_dataframe(pd.read_parquet(args.data))


def _resolve_text_tower(config: Config, has_text: bool):
    """The item text encoder for data with text and its pretrained text-table
    init, resolved before the config snapshot: ``(config, encoder,
    text_embedding_init)`` (JAX ``train.py:171-198``). ``text_encoder=
    "hashed"`` with ``text_buckets > 0`` gives a ``HashedNgramEncoder`` and
    a random text table; ``"transformer"`` a ``TransformerTextEncoder``,
    ``model.text_buckets`` resolved to its tokenizer's vocabulary + 1 and,
    with ``model.text_pretrained_init``, the PCA-projected word embeddings
    as the table's init (a model that cannot be loaded keeps the random
    init, with a warning)."""
    if not has_text:
        return config, None, None
    from twotower_tpu_torch.features.transformer_encoder import build_text_encoder

    encoder = build_text_encoder(config.model)
    text_embedding_init = None
    if encoder is not None and config.model.text_encoder == "transformer":
        if config.model.text_buckets != encoder.num_buckets:
            # evaluate-model and serve-model rebuild the table from the snapshot.
            config = config.with_overrides({"model.text_buckets": encoder.num_buckets})
        if config.model.text_pretrained_init:
            try:
                text_embedding_init = encoder.word_embedding_init(config.model.embedding_dim)
            except (OSError, ValueError) as exc:
                logger.warning(
                    "no pretrained weights at %s (%s); text table keeps random init",
                    config.model.text_model_path, exc,
                )
    return config, encoder, text_embedding_init


def _log_text_tower(config: Config, item_tokens) -> None:
    if item_tokens is not None:
        logger.info(
            "text tower on (%s): %d buckets x %d tokens/item",
            config.model.text_encoder, config.model.text_buckets, config.model.text_tokens,
        )


class _EncodedColumns:
    """Minimal encoded-columns view (what BatchPipeline and DeviceDataset read)."""

    def __init__(self, user_idx, item_idx):
        self.user_idx = user_idx
        self.item_idx = item_idx

    def __len__(self) -> int:
        return len(self.user_idx)


def _resolve_forced_rung(args) -> None:
    """``--exec`` is sugar over the rung-forcing flags, as in the JAX CLI."""
    if args.exec_rung == "device-loop":
        args.device_loop = True
    elif args.exec_rung == "stream":
        args.stream_batches = True
    if args.stream_batches and args.device_loop:
        raise SystemExit(
            "--stream-batches is incompatible with --device-loop (the "
            "device-resident epoch holds all train columns on device)"
        )


def _sequence_rung(args, config: Config) -> None:
    """A sequence user tower trains on the device loop: its epoch is packed
    streams of user windows (``data.sequences.StreamDataset``), which the
    host and streamed rungs do not build."""
    if config.model.user_tower != "sequence":
        return
    if args.stream_batches or args.exec_rung == "host" or args.mesh:
        raise SystemExit("model.user_tower=sequence trains on one device's device loop "
                         "only (--exec auto or device-loop, no --mesh)")
    if not args.device_loop:
        logger.info("execution rung: device_loop — the sequence user tower's packed "
                    "streams live on the device")
    args.device_loop = True


def _build_mesh(args, config: Config):
    """The mesh of ``--mesh`` (None without it)."""
    if not args.mesh:
        return None
    from twotower_tpu_torch.parallel import build_mesh

    return build_mesh(config.mesh, device=args.device)


def _is_main(mesh) -> bool:
    """Whether this process writes the run's artifacts (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def run(args, config: Config) -> dict:
    from twotower_tpu_torch.data import Preprocessor

    _resolve_forced_rung(args)
    _sequence_rung(args, config)
    mesh = _build_mesh(args, config)
    if args.prepared_dir:
        return _run_prepared(args, config, mesh)
    if args.stream_batches:
        # The stream rung reads a prepare-data artifact; the in-memory path
        # has none, so it trains on the host loop and reports so.
        logger.warning("--stream-batches needs --prepared-dir; running the host loop")
        args.stream_batches = False
    data = load_interactions(args)
    pp = Preprocessor(config.preprocessing)
    data = pp.process(data)
    splits = pp.split_data(data, method=args.split)
    num_users, num_items = len(pp.vocab.users), len(pp.vocab.items)
    logger.info(
        "data: %d train / %d val / %d test; %d users, %d items",
        len(splits.train), len(splits.val), len(splits.test), num_users, num_items,
    )
    ckpt_dir, manager, writers = _outputs(args, config, mesh)
    config, encoder, text_embedding_init = _resolve_text_tower(
        config, splits.train.text is not None or splits.train.title is not None
    )
    item_tokens = None
    if encoder is not None:
        item_tokens = encoder.encode_per_item(
            data.item_idx, data.text, num_items, titles=data.title
        )
    _log_text_tower(config, item_tokens)
    return _fit_and_summarize(
        args,
        config,
        num_users=num_users,
        num_items=num_items,
        log_q=np.log(pp.vocab.items.frequencies + 1e-12),
        item_tokens=item_tokens,
        text_embedding_init=text_embedding_init,
        ckpt_dir=ckpt_dir,
        manager=manager,
        writers=writers,
        save_vocab=lambda d: pp.vocab.save(d / "vocab"),
        train_cols=_EncodedColumns(splits.train.user_idx, splits.train.item_idx),
        val_arrays=(splits.val.user_idx, splits.val.item_idx),
        test_arrays=(splits.test.user_idx, splits.test.item_idx),
        mesh=mesh,
    )


def _outputs(args, config: Config, mesh=None):
    """The checkpoint directory, its manager and the metric writers (a
    mesh's other ranks write no metrics file)."""
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager
    from twotower_tpu_torch.utils.tracking import build_writers

    ckpt_dir = Path(args.checkpoint_dir or config.training.checkpoint_dir)
    manager = CheckpointManager(
        ckpt_dir, keep=config.training.keep_checkpoints,
        async_save=config.training.async_checkpoint,
        min_interval_s=config.training.checkpoint_min_interval_s,
    )
    writers = build_writers(args.writers if _is_main(mesh) else [],
                            jsonl_path=ckpt_dir / "metrics.jsonl")
    return ckpt_dir, manager, writers


def _run_prepared(args, config: Config, mesh=None) -> dict:
    """``--prepared-dir``: the encoded columns and vocab of a prepare-data
    artifact, without preprocessing again; ``--exec auto`` chooses the rung
    from the device's and the host's free memory (``training.rungs``)."""
    from twotower_tpu_torch.data.prepared import PreparedDataset
    from twotower_tpu_torch.training import rungs

    dataset = PreparedDataset(args.prepared_dir, batch_rows=args.batch_rows)
    num_users, num_items = dataset.num_users, dataset.num_items
    rule = dataset.temporal_rule(
        config.preprocessing.train_split, config.preprocessing.val_split
    )
    logger.info(
        "prepared data: %d train / %d val / %d test; %d users, %d items",
        rule.n_train, rule.n_val, rule.n_test, num_users, num_items,
    )
    if args.exec_rung == "auto" and not args.device_loop and not args.stream_batches:
        decision = rungs.choose_execution_rung(
            n_train=rule.n_train,
            num_users=num_users,
            num_items=num_items,
            config=config,
            device_free_bytes=rungs.device_free_bytes(args.device),
            host_available_bytes=rungs.host_available_bytes(),
            has_eval=not args.no_eval,
        )
        logger.info("execution rung: %s (auto) — %s", decision.rung, decision.reason)
        if decision.rung == "device_loop":
            args.device_loop = True
        elif decision.rung == "stream":
            args.stream_batches = True
            if args.shuffle_buffer is None:
                args.shuffle_buffer = decision.shuffle_buffer
    if args.shuffle_buffer is None:
        args.shuffle_buffer = 1 << 23
    ckpt_dir, manager, writers = _outputs(args, config, mesh)
    config, encoder, text_embedding_init = _resolve_text_tower(config, dataset.has_text)
    item_tokens = dataset.build_item_tokens(encoder)
    _log_text_tower(config, item_tokens)

    train_cols = None
    train_pipeline = None
    if args.stream_batches:
        # One classification scan materializes both held-out splits.
        splits = dataset.load_splits(rule, ("val", "test"))
        host_spans = None
        if mesh is not None:
            from twotower_tpu_torch.parallel.sharding import process_row_spans

            host_spans = process_row_spans(mesh, config.training.batch_size)
        train_pipeline = dataset.train_pipeline(
            rule, config.training.batch_size, seed=config.training.seed,
            shuffle_buffer=args.shuffle_buffer, host_spans=host_spans,
            shard_input=args.shard_input,
        )
    else:
        # All three splits in one full-corpus scan.
        splits = dataset.load_splits(rule, ("train", "val", "test"))
        train = splits["train"]
        train_cols = _EncodedColumns(train["user_idx"], train["item_idx"])
    val, test = splits["val"], splits["test"]
    return _fit_and_summarize(
        args,
        config,
        num_users=num_users,
        num_items=num_items,
        log_q=dataset.log_q(),
        item_tokens=item_tokens,
        text_embedding_init=text_embedding_init,
        ckpt_dir=ckpt_dir,
        manager=manager,
        writers=writers,
        save_vocab=lambda d: dataset.vocab.save(d / "vocab"),
        train_cols=train_cols,
        train_pipeline=train_pipeline,
        val_arrays=(val["user_idx"], val["item_idx"]),
        test_arrays=(test["user_idx"], test["item_idx"]),
        mesh=mesh,
    )


def _fit_and_summarize(
    args,
    config: Config,
    *,
    num_users: int,
    num_items: int,
    log_q,
    item_tokens,
    text_embedding_init,
    ckpt_dir: Path,
    manager,
    writers,
    save_vocab,
    val_arrays,
    test_arrays,
    train_cols=None,
    train_pipeline=None,
    mesh=None,
) -> dict:
    """Config snapshot -> the rung's trainer -> fit -> artifacts + summary.
    The device loop takes ``train_cols``; the host loop a ``BatchPipeline``
    over them (on a mesh, the rank's rows of each batch), or the streamed
    ``train_pipeline``. On a mesh every rank trains and evaluates, and rank
    0 alone writes the files."""
    from twotower_tpu_torch.data import BatchPipeline
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.training.device_loop import DeviceDataset, DeviceTrainer
    from twotower_tpu_torch.training.loop import Trainer
    from twotower_tpu_torch.utils.profiling import GracefulShutdown, trace

    # The RESOLVED config beside the checkpoint: evaluate-model rebuilds the
    # trained shape from it without the overrides (load_config_for_checkpoint).
    main_rank = _is_main(mesh)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    if main_rank:
        (ckpt_dir / "config.json").write_text(config.to_json())
        if item_tokens is not None:
            np.savez_compressed(ckpt_dir / "item_tokens.npz", tokens=item_tokens)

    histories = None
    if config.model.user_tower == "sequence":
        from twotower_tpu_torch.data.sequences import UserHistories
        from twotower_tpu_torch.models.two_tower import padded_rows

        histories = UserHistories(train_cols.user_idx, train_cols.item_idx, num_users,
                                  config.model.sequence.max_window, padded_rows(num_items) - 1,
                                  device=args.device)
    evaluator = Evaluator(config, num_items, item_tokens=item_tokens, device=args.device,
                          mesh=mesh, histories=histories)
    val_u, val_i = val_arrays
    cap = getattr(args, "val_rows", None)
    if cap and cap < len(val_u):
        sel = strided_subsample(len(val_u), cap)
        logger.info(
            "validation capped: %d of %d held-out rows (stride %d)",
            len(sel), len(val_u), sel[1] - sel[0] if len(sel) > 1 else 1,
        )
        val_u, val_i = val_u[sel], val_i[sel]
    evaluate_fn = (
        None if args.no_eval or len(val_u) == 0 else evaluator.make_evaluate_fn(val_u, val_i)
    )
    shutdown = GracefulShutdown().install()
    try:
        trainer_cls = DeviceTrainer if args.device_loop else Trainer
        trainer = trainer_cls(
            config,
            log_q=log_q,
            evaluate_fn=evaluate_fn,
            writers=writers,
            checkpoint_manager=manager,
            shutdown=shutdown,
            item_tokens=item_tokens,
            num_items=num_items,
            text_embedding_init=text_embedding_init,
            device=args.device,
            mesh=mesh,
        )
        if config.model.user_tower == "sequence":
            from twotower_tpu_torch.data.sequences import StreamDataset

            train_input = StreamDataset(train_cols.user_idx, train_cols.item_idx, config,
                                        device=trainer.device)
            logger.info("sequence tower: %d slots in %d streams of %d", train_input.num_examples,
                        train_input.num_steps, train_input.batch_size)
        elif args.device_loop:
            train_input = DeviceDataset.from_interactions(
                train_cols, config.training.batch_size, device=trainer.device
            )
        elif train_pipeline is not None:
            train_input = train_pipeline
        else:
            host_spans = None
            if mesh is not None:
                from twotower_tpu_torch.parallel.sharding import process_row_spans

                host_spans = process_row_spans(mesh, config.training.batch_size)
                logger.info("mesh input: rank %d/%d feeds rows %s of each %d-row batch",
                            mesh.rank, mesh.world, host_spans, config.training.batch_size)
            train_input = BatchPipeline(
                train_cols, config.training.batch_size, seed=config.training.seed,
                host_spans=host_spans,
            )
        state = trainer.init_state(num_users, num_items)
        start_epoch = 0
        if args.resume and manager.latest_step() is not None:
            state, meta = manager.restore(state)
            start_epoch = int(meta.get("epoch", 0))
            logger.info("resumed from step %d (epoch %d)", int(state.step), start_epoch)
        with trace(args.profile_dir):
            result = trainer.fit(state, train_input, start_epoch=start_epoch)
    finally:
        shutdown.uninstall()

    # Final artifacts: vocab manifest + final checkpoint + test metrics.
    # With validation, improving epochs already saved the BEST checkpoint
    # and the final state is persisted only when nothing was saved yet;
    # without validation nothing saved in the loop, so the final state is
    # always saved ("epoch" is where --resume restarts).
    if main_rank:
        save_vocab(ckpt_dir)
    if evaluate_fn is None or manager.latest_step() is None:
        manager.save(
            int(result.state.step),
            result.state,
            extra={"epoch": start_epoch + len(result.history)},
        )
    manager.flush()  # async managers: durability before the CLI returns
    test_metrics = (
        evaluator.evaluate(result.state.params, test_arrays[0], test_arrays[1])
        if len(test_arrays[0])
        else {}
    )
    for w in writers:
        w.close()

    summary = {
        # None (JSON null) when no validation ran: json.dumps would
        # otherwise emit the non-standard ``-Infinity`` literal.
        "best_val_metric": result.best_metric if np.isfinite(result.best_metric) else None,
        "best_step": result.best_step,
        "examples_per_sec": result.examples_per_sec,
        "train_examples_per_sec": result.train_examples_per_sec,
        "steady_examples_per_sec": result.steady_examples_per_sec,
        "epochs_run": len(result.history),
        "test": test_metrics,
        "checkpoint_dir": str(ckpt_dir),
        "num_users": num_users,
        "num_items": num_items,
        # The rung that ran (chosen by --exec auto or forced).
        "execution_rung": (
            "device_loop" if args.device_loop
            else "stream" if args.stream_batches
            else "host"
        ),
        "device": str(trainer.device),
    }
    if mesh is not None:
        summary["mesh"] = {"data": mesh.num_data, "model": mesh.num_model, "rank": mesh.rank,
                           "backend": mesh.backend}
    if main_rank:
        (ckpt_dir / "train_summary.json").write_text(json.dumps(summary, indent=2))
    return summary


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
    config = load_config(args.config, parse_cli_overrides(args.override))
    owned = join_process_group(args)
    try:
        summary = run(args, config)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(json.dumps(summary))
    return 0


def join_process_group(args) -> bool:
    """With ``--mesh`` or ``--coordinator``, join the process group before
    anything else (the checkpoint manager asks for the world size); True
    when this call created it. Shared with evaluate-model."""
    if not (args.mesh or args.coordinator):
        return False
    from twotower_tpu_torch.parallel.mesh import default_backend, initialize_multihost

    return initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                backend=default_backend(args.device))


if __name__ == "__main__":
    sys.exit(main())

"""The oracle student under variants: where its ceiling fraction comes from.

    python -m twotower_tpu_torch.tools.oracle_variants [--scale config2]
        [--variants base seed1 host plain bf16loss ...] [--device cuda]

Generates the preset's corpus, prepares it and scores its ceiling once
(``tools/oracle_parity.py``'s first three stages), then trains and
evaluates the student once per variant, in this process, and prints each
variant's ``ceiling_fraction["recall@10"]``, best validation recall@10,
epochs and validation curve; each variant's summary, evaluation and epoch
records go to ``<work-dir>/variants/<name>.json``. The variants:

- ``base``: the preset as it is; ``seedN``: with ``training.seed=N``;
- ``host``: ``--exec host`` (the eager host loop, not the device loop);
- ``f32``: ``model.compute_dtype=float32``;
- ``plain``: the in-batch loss's plain PyTorch version in place of its
  kernels;
- ``bf16loss``: the plain loss over bfloat16-rounded embeddings (a one-pass
  bf16 product, the precision a TPU's default gives a float32 product).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from twotower_tpu_torch.tools import oracle_parity as op


@contextlib.contextmanager
def _loss_in_place_of_kernels(round_bf16: bool):
    """Route the CUDA in-batch loss to its plain version (operands rounded
    to bfloat16 with ``round_bf16``) while inside."""
    from twotower_tpu_torch.ops import kernels, losses

    orig = kernels.fused_in_batch_softmax_loss

    def plain(u, v, *args, **kwargs):
        if round_bf16:
            u, v = u.bfloat16().float(), v.bfloat16().float()
        return losses.in_batch_softmax_loss(u, v, *args, **kwargs)

    kernels.fused_in_batch_softmax_loss = plain
    try:
        yield
    finally:
        kernels.fused_in_batch_softmax_loss = orig


def _variant(name: str) -> tuple[list[str], list[str], object]:
    """(extra overrides, extra train flags, context) of a variant name."""
    if name == "base":
        return [], [], contextlib.nullcontext()
    if name.startswith("seed") and name[4:].isdigit():
        return [f"training.seed={int(name[4:])}"], [], contextlib.nullcontext()
    if name == "host":
        return [], ["--exec", "host"], contextlib.nullcontext()
    if name == "f32":
        return ["model.compute_dtype=float32"], [], contextlib.nullcontext()
    if name in ("plain", "bf16loss"):
        return [], [], _loss_in_place_of_kernels(name == "bf16loss")
    raise SystemExit(f"unknown variant {name!r}")


def main(argv: list[str] | None = None) -> int:
    from twotower_tpu_torch.utils.platform import resolve_device

    ap = argparse.ArgumentParser(prog="python -m twotower_tpu_torch.tools.oracle_variants")
    ap.add_argument("--scale", choices=sorted(op.SCALES), default="config2")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--work-dir", type=str, default=None,
                    help="default build/oracle_variants_<scale> in the repository")
    ap.add_argument("--variants", nargs="+", default=["base"])
    args = ap.parse_args(argv)
    resolve_device(args.device)  # no GPU: raise before any work
    for name in args.variants:
        _variant(name)  # unknown names fail before any work
    work = Path(args.work_dir or op.REPO / "build" / f"oracle_variants_{args.scale}")
    work.mkdir(parents=True, exist_ok=True)
    stages = {s[0]: s for s in op.stage_commands(args.scale, work, device=args.device)}
    for name in ("generate", "prepare", "ceiling"):
        out = op.in_process_runner(*stages[name][1:])
    ceiling = op.last_json_line(out)["metrics"]["recall@10"]
    print(f"ceiling recall@10 {ceiling}", flush=True)
    model = op.SCALES[args.scale]["model"]
    epochs = op.SCALES[args.scale]["epochs"]
    (work / "variants").mkdir(exist_ok=True)
    for name in args.variants:
        over, flags, ctx = _variant(name)
        ckpt = work / f"ckpt_{name}"
        train_argv = ["--prepared-dir", str(work / "prepared"), "--checkpoint-dir", str(ckpt),
                      "--val-rows", "200000", "--device", args.device, *flags,
                      "--override", f"training.epochs={epochs}", *model, *over]
        eval_argv = ["--prepared-dir", str(work / "prepared"), "--checkpoint-dir", str(ckpt),
                     "--subset", "test", "--device", args.device, "--override", *model, *over]
        t0 = time.perf_counter()
        with ctx:
            summary = op.last_json_line(op.in_process_runner("twotower_tpu_torch.training.train",
                                                             train_argv))
            student = op.last_json_line(op.in_process_runner(
                "twotower_tpu_torch.evaluation.evaluate", eval_argv))
        records = [r for r in map(json.loads, (ckpt / "metrics.jsonl").read_text().splitlines())
                   if "epoch" in r]
        (work / "variants" / f"{name}.json").write_text(json.dumps(
            {"summary": summary, "student": student, "epochs": records}))
        curve = [r.get("val/recall@10") for r in records]
        print(f"{name}: ceiling fraction {student['metrics']['recall@10'] / ceiling} (test "
              f"recall@10 {student['metrics']['recall@10']}); best val recall@10 "
              f"{summary['best_val_metric']} at step {summary['best_step']}, "
              f"{summary['epochs_run']} epochs, {summary['execution_rung']}, "
              f"{time.perf_counter() - t0:.1f} s; val recall@10 by epoch {curve}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A/B runs of checkouts of this repository on one CUDA card.

    python3 twotower_tpu_torch/tools/ab_step.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (the directory that holds
``twotower_tpu_torch/``), measured in a process of its own, in the order
given: ``parent change change parent`` compares two revisions on one card.
The measurements are this checkout's ``chip_smoke.py`` functions applied to
each ROOT's package:

- per kernel wrapper (``fused_fwd``, ``fused_bwd_du``, ``fused_bwd_dv``)
  at B=4096, D=128: ``ms`` and ``ms_batched`` (device time of a call, as
  in ``chip_smoke.py`` phase 6), ``host_us`` (host time of a call, made
  with the card idle) and ``sha256`` (of its outputs' bytes, the same
  inputs in every run: equal hashes are equal bits);
- ``step_ms``: the main path of ``chip_smoke.py`` phase 5 (default model,
  batch 4096, 1M x 500k tables, median of 20 steps after 5; every kernel
  must have launched).

It prints each run's output, one line ``ab: {...}`` a run, and the card's
name and power limit. Any failure exits non-zero.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: Path) -> dict:
    """One run, in this process, of the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    from twotower_tpu_torch.ops import kernels

    if not Path(kernels.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {kernels.__file__}, not the package under {root}")
    smoke = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    u, v, ids, cols, g = smoke.loss_inputs(smoke.MAIN_B, smoke.MAIN_D, smoke.MAIN_B, seed=7)
    inv_temp = 1 / smoke.TEMP
    lse = kernels.fwd_plain(u, v, ids, cols, 0, inv_temp)[1]
    fwd_args = (u, v, ids, cols, 0, inv_temp)
    bwd_args = (u, v, ids, cols, 0, lse, g, inv_temp)
    out = {"root": str(root)}
    for fn, args in ((kernels.fused_fwd, fwd_args), (kernels.fused_bwd_du, bwd_args),
                     (kernels.fused_bwd_dv, bwd_args)):
        def call(fn=fn, args=args):
            return fn(*args)

        result = call()
        result = result if isinstance(result, tuple) else (result,)
        out[fn.__name__] = {
            "sha256": hashlib.sha256(
                b"".join(t.contiguous().cpu().numpy().tobytes() for t in result)
            ).hexdigest()[:16],
            "ms": smoke.time_ms(call),
            "ms_batched": smoke.time_ms_batched(call),
            "host_us": smoke.host_us(call),
        }
    _, out["step_ms"] = smoke.run_main_path()
    return out


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        print("ab: " + json.dumps(measure(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(_chip_smoke().card_line(), flush=True)
    for root in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", root], capture_output=True,
                              text=True, timeout=900)
        print(f"--- {root} (exit {proc.returncode})\n{proc.stdout}", flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

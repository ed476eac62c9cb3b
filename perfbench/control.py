"""Readings that set a cell's limits: for each seed, a run of the program
(set-up, a window of ``--seconds`` at the cell's own load, the check) and
its control, the reference in a lower precision than the configuration's
put in the program's place, both against the reference.

    python3 perfbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

Prints one JSON line a seed: ``{"seed", "program": {number: reading},
"control": {number: reading}}``. The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path.cwd()


def readings(cell, seed: int, seconds: float, device: str) -> dict:
    import torch

    from perfbench.harness.manifest import driver_of
    from perfbench.harness.runner import Run

    driver = driver_of(cell)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    obj = driver.setup(run)
    out = driver.window(obj, seconds)
    kept = driver.release(obj)
    del obj
    t = time.perf_counter()
    program = driver.check(kept, run)
    check_s = time.perf_counter() - t
    control = driver.control(kept, run)
    del kept
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"seed": seed, "failed": out["failed"], "e2e": out["e2e"], "check_s": check_s,
            "program": program, "control": control}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from perfbench.harness.manifest import load_cell
    from perfbench.harness.runner import cache_dirs

    cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = load_cell(ROOT, args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the result as the last line of
standard output, and each number the check compared beside its limit as the
last lines of standard error. Exits with another code than 0 and prints no
result where there is no card (or fewer than the cell asks for), where the
program (``twotower_tpu_torch``) is not in the checkout, or where JAX or the
JAX package got loaded.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up is timed from here: the imports and the device's start

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from perfbench.harness.manifest import load_cell
    from perfbench.harness.runner import cache_dirs, loaded_forbidden, print_result, run_cell

    cache_dirs(ROOT)
    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        import twotower_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout: {e}", file=sys.stderr)
        return 4
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                    log=lambda msg: print(msg, file=sys.stderr, flush=True), started=STARTED)
    found = loaded_forbidden()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 5
    print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Find the highest request rate a serving cell sustains: one set-up, then
an open loop of ``--seconds`` at each rate in turn, each from a full
collection of the garbage collector. A rate is sustained where nearly every
request completes, the latency of the window's last quarter stays within
twice its first quarter's and the window drains within 5% of its length (no
growing backlog), and the 99th percentile meets the traffic file's
``slo_p99_ms``.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

Prints one JSON line a rate. The cell's traffic file fixes its rate once
from such a sweep (at about four fifths of the highest rate sustained); the
benchmark's runs never sweep.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path.cwd()


def sustained(latency_s: np.ndarray, due: np.ndarray, seconds: float, wall: float,
              slo_ms: float) -> dict:
    done = np.isfinite(latency_s)
    first = latency_s[(due < seconds / 4) & done]
    last = latency_s[(due >= 3 * seconds / 4) & done]
    p50_first = float(np.median(first)) * 1e3 if len(first) else float("inf")
    p50_last = float(np.median(last)) * 1e3 if len(last) else float("inf")
    return {"completed_share": float(done.mean()), "p50_first_ms": p50_first,
            "p50_last_ms": p50_last,
            "sustained": bool(done.mean() > 0.999 and p50_last <= 2 * p50_first
                              and wall <= 1.05 * seconds
                              and np.percentile(latency_s, 99) * 1e3 <= slo_ms)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--rates", type=float, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    from perfbench.drivers import serve
    from perfbench.harness import stats
    from perfbench.harness import traffic as tr
    from perfbench.harness.manifest import load_cell
    from perfbench.harness.runner import Run, cache_dirs

    cache_dirs(ROOT)
    cell = load_cell(ROOT, args.workload)
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=False, device="cuda")
    obj = serve.setup(run)
    for rate in args.rates:
        gc.collect()
        due = tr.poisson_arrivals(rate, args.seconds, args.seed + int(rate))
        users = obj.users[np.arange(len(due)) % len(obj.users)]
        (latency, late, _, errors, wall, _), calls = serve._drive(obj, due, users, set(),
                                                                   obj.drain_s)
        ms = latency * 1e3
        print(json.dumps({"rate": rate, "requests": len(due), "wall_s": wall,
                          "completed_per_s": float(np.isfinite(latency).sum()) / wall,
                          "p50_ms": stats.percentile(ms, 50), "p99_ms": stats.percentile(ms, 99),
                          "rows_per_call": float(np.isfinite(latency).sum()) / max(calls, 1),
                          "late_p99_ms": float(np.percentile(late, 99)) * 1e3,
                          "errors": len(errors),
                          **sustained(latency, due, args.seconds, wall,
                                      float(cell.traffic["slo_p99_ms"]))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, and the result line.

``run_cell`` takes the device as an argument so that the tests drive a
whole run on the CPU at a tiny size; ``perfbench/run.py`` is the command
that looks for the card first.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness.manifest import Cell, driver_of, metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "twotower_tpu")


@dataclass
class Run:
    """What a driver is told about the run."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    marks: list = field(default_factory=list)  # (phase, time.perf_counter() at its end)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, for the log."""
        self.marks.append((phase, time.perf_counter()))

    @property
    def program_seed(self) -> int:
        """The program's own ``training.seed``: the run's seed within the
        31 bits the program's generators are seeded from."""
        return self.seed % (1 << 31)


@dataclass
class MetricContext:
    """What a per-layer metric's reader is given: the cell's configuration
    and traffic files, the window's end-to-end values, what the driver
    measured by layer, and the traced window (``harness/trace.py``)."""

    config: dict
    traffic: dict
    e2e: dict
    layer: dict
    trace: object


def loaded_forbidden() -> list[str]:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name (``twotower_tpu_torch`` is not ``twotower_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card() -> dict:
    """The card's name, and its power limit where ``nvidia-smi`` reads it."""
    info = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=False)
        info["power_limit_w"] = float(out.stdout.splitlines()[0].split(",")[1])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        info["power_limit_w"] = None
    return info


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             log=print, started: float | None = None) -> dict:
    """Run ``cell`` once and return its result line as a dict. Set-up is
    timed from ``started`` (the process's start, by ``time.perf_counter``),
    so that it holds the start of the device and the imports."""
    t0 = time.perf_counter() if started is None else started
    driver = driver_of(cell)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device)
    run.mark("imports")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        run.mark("device")
    obj = driver.setup(run)
    gc.collect()  # every window starts from the same state of the collector
    _sync(device)
    run.mark("collect")
    setup_s = time.perf_counter() - t0
    phases, last = [], t0
    for phase, t in run.marks:
        phases.append(f"{phase} {t - last:.3f}")
        last = t
    log(f"set-up {setup_s:.3f} s: {', '.join(phases)}")
    out = driver.window(obj, seconds)
    log(f"window: {json.dumps(out['e2e'])}, attempted {out['attempted']}, failed {out['failed']}")
    layer = dict(out["layer"])
    tr = None
    if trace:
        extra, tr = driver.trace(obj, run)
        layer.update(extra)
        log(f"traced window {tr.window_s:.3f} s, busy {tr.busy_s:.3f} s, reduced in "
            f"{extra.get('reduce_s', 0.0):.3f} s")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kept = driver.release(obj)
    del obj
    t = time.perf_counter()
    numbers = driver.check(kept, run)
    log(f"check {time.perf_counter() - t:.3f} s")
    limits = cell.traffic["check"]
    compared = {name: {"value": float(numbers[name]), "limit": float(limits[name])}
                for name in limits}
    correct = out["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    values = {"setup_s": setup_s, **out["e2e"]}
    if trace:
        ctx = MetricContext(config=cell.config, traffic=cell.traffic, e2e=values, layer=layer,
                            trace=tr)
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(cell, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu", "count": cell.chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if cuda:
        info = card()
        dev["kind"] = info["kind"]
        line["card"] = info
    if trace:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        line["breakdown"] = tr.breakdown()
    line["compared"] = compared
    return line


def print_result(line: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def cache_dirs(root) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(str(root), "build", "perfbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A configuration is ``configs/<name>.json`` (the manifest's ``file``), a
traffic mix ``traffic/<name>.json`` whose ``driver`` names
``drivers/<driver>.py``, and a per-layer metric ``metrics/<name>.py`` with a
``read(ctx)`` function. Adding a cell, a mix or a metric adds files and
manifest entries; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

MANIFEST = "BENCHMARK.json"
BENCH_DIR_NAME = "perfbench"


@dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path

    @property
    def bench_dir(self) -> Path:
        return self.root / BENCH_DIR_NAME


def load_manifest(root: Path) -> dict:
    path = Path(root) / MANIFEST
    if not path.is_file():
        raise FileNotFoundError(f"{MANIFEST} not found in {root}")
    return json.loads(path.read_text())


def _named(entries: list[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r}: {len(found)} entries in {MANIFEST}")
    return found[0]


def load_cell(root: Path, workload: str) -> Cell:
    """The workload ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix and metrics."""
    root = Path(root)
    manifest = load_manifest(root)
    w = _named(manifest["workloads"], workload, "workload")
    c = _named(manifest["configs"], w["config"], "config")
    config = json.loads((root / c["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR_NAME / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [
        m for m in manifest["per_layer"]
        if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)
    ]
    return Cell(name=workload, chips=int(w["chips"]), config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, root=root)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot import {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver_of(cell: Cell) -> ModuleType:
    name = cell.traffic["driver"]
    path = cell.bench_dir / "drivers" / f"{name}.py"
    return load_module(path, f"perfbench_driver_{name}")


def metric_reader(cell: Cell, metric: str) -> ModuleType:
    path = cell.bench_dir / "metrics" / f"{metric}.py"
    return load_module(path, "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"))

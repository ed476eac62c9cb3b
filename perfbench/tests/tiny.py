"""A copy of the benchmark at tiny sizes, for runs on the CPU: the repo's
``BENCHMARK.json`` and ``perfbench/`` copied into a directory, with each
configuration and traffic file cut to sizes a test can hold. Widths shrink
too (this is a test of the harness, not a cell)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = {"embedding_dim": 16, "user_tower_dims": [32, 16], "item_tower_dims": [32, 16]}
CONFIGS = {
    "lifecycle_50m_1chip": {"num_users": 300, "num_items": 2000,
                            "port.training.batch_size": 64},
    "catalog_10m_int8": {"num_users": 400, "num_items": 3000},
}
TRAFFIC = {
    "train_lifecycle_epochs": {"rows_per_epoch": 1000, "trace_seconds": 0.2, "replays_timed": 4,
                               "items": {"dist": "catalog_drift", "clusters": 16, "latent_dim": 4,
                                         "size_concentration": 8.0, "affinity_scale": 4.0,
                                         "noise": 0.3, "within_zipf": 0.8,
                                         "catalog_start_frac": 0.6, "num_eras": 12,
                                         "drift_ranks_per_era": 3, "span": [0.0, 0.8],
                                         "chunks": 4}},
    "validate_approx_500k": {"rows": 1500, "sampled_rows": 64, "trace_rows": 256,
                             "weights": {"kind": "planted", "clusters": 64, "noise": 0.5},
                             "items": {"dist": "same_cluster", "clusters": 64}},
    "eval_exact_1m": {"rows": 1500, "sampled_rows": 64, "trace_rows": 256,
                      "weights": {"kind": "planted", "clusters": 64, "noise": 0.5},
                      "items": {"dist": "same_cluster", "clusters": 64}},
    "recommend_poisson": {"rate": 100, "sampled_requests": 40, "trace_seconds": 0.3,
                          "drain_seconds": 30},
}


def _set(d: dict, dotted: str, value) -> None:
    *parents, leaf = dotted.split(".")
    for p in parents:
        d = d[p]
    d[leaf] = value


def tiny_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``perfbench/`` at tiny sizes."""
    dest = Path(dest)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, changes in CONFIGS.items():
        path = dest / "perfbench" / "configs" / f"{name}.json"
        conf = json.loads(path.read_text())
        conf["port"]["model"].update(TINY_MODEL)
        for k, v in changes.items():
            _set(conf, k, v)
        path.write_text(json.dumps(conf))
    for name, changes in TRAFFIC.items():
        path = dest / "perfbench" / "traffic" / f"{name}.json"
        traffic = json.loads(path.read_text())
        traffic.update(changes)
        path.write_text(json.dumps(traffic))
    return dest

"""Experiment tracking: pluggable metric writers (PyTorch port).

The port's copy of ``twotower_tpu/utils/tracking.py``: a tiny writer
protocol — ``write(metrics, step)`` — with stdout/JSONL built-ins and
optional TensorBoard/MLflow/W&B adapters that import their backend lazily
and raise a clear error when it is missing (the JAX package's adapters
turn into no-ops instead).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Protocol

from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)


class MetricWriter(Protocol):
    def write(self, metrics: dict[str, float], step: int) -> None: ...
    def close(self) -> None: ...


class StdoutWriter:
    """Human-readable one-liner per write."""

    def write(self, metrics: dict[str, float], step: int) -> None:
        parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(metrics.items()))
        logger.info("[step %d] %s", step, parts)

    def close(self) -> None:  # pragma: no cover - nothing to release
        pass


class JsonlWriter:
    """Append-only JSONL file — the durable default artifact."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def write(self, metrics: dict[str, float], step: int) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class MLflowWriter:
    """Adapter for the reference's declared MLflow tracking; lazy import."""

    def __init__(self, run_name: str | None = None, tracking_uri: str | None = None):
        mlflow = _require("mlflow", "MLflowWriter")
        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.start_run(run_name=run_name)

    def write(self, metrics: dict[str, float], step: int) -> None:
        clean = {k.replace("@", "_at_"): v for k, v in metrics.items()}
        self._mlflow.log_metrics(clean, step=step)

    def close(self) -> None:
        self._mlflow.end_run()


class WandbWriter:
    """Adapter for the reference's declared W&B tracking; lazy import."""

    def __init__(self, project: str | None = None, config: dict | None = None):
        wandb = _require("wandb", "WandbWriter")
        self._run = wandb.init(project=project, config=config or {})

    def write(self, metrics: dict[str, float], step: int) -> None:
        self._run.log(metrics, step=step)

    def close(self) -> None:
        self._run.finish()


class TensorBoardWriter:
    """TensorBoard event files through ``torch.utils.tensorboard`` (which
    needs the ``tensorboard`` package; lazy import)."""

    def __init__(self, logdir: str | Path = "logs/tensorboard"):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorBoardWriter needs the tensorboard package "
                "(torch.utils.tensorboard); install it or drop 'tensorboard' "
                "from --writers"
            ) from e
        self._writer = SummaryWriter(log_dir=str(logdir))

    def write(self, metrics: dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            self._writer.add_scalar(k, float(v), global_step=step)

    def close(self) -> None:
        self._writer.close()


def _require(module: str, writer: str):
    """Import an optional tracking backend, or raise saying which writer
    needed it."""
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"{writer} needs the {module} package; install it or drop "
            f"'{module}' from --writers"
        ) from e


def build_writers(
    kinds: list[str],
    *,
    jsonl_path: str | Path = "logs/metrics.jsonl",
    run_name: str | None = None,
) -> list[Any]:
    """Writer factory from config/CLI strings:
    stdout | jsonl | tensorboard | mlflow | wandb."""
    out: list[Any] = []
    for kind in kinds:
        if kind == "stdout":
            out.append(StdoutWriter())
        elif kind == "jsonl":
            out.append(JsonlWriter(jsonl_path))
        elif kind == "tensorboard":
            out.append(TensorBoardWriter(Path(jsonl_path).parent / "tensorboard"))
        elif kind == "mlflow":
            out.append(MLflowWriter(run_name=run_name))
        elif kind == "wandb":
            out.append(WandbWriter(project=run_name))
        else:
            raise ValueError(f"unknown metric writer {kind!r}")
    return out

"""Structured logging for the PyTorch port (its own copy of
``twotower_tpu/logging_utils.py``).

Parity with the reference's logging setup (reference:
configs/logging/logging.yaml:1-58 — console + rotating file handlers, a JSON
formatter, per-module levels) without requiring an external YAML file or the
``pythonjsonlogger`` dependency.

Multi-host behavior: on a multi-host run only process 0 logs at INFO by
default; other hosts are raised to WARNING so pod-scale runs do not emit
N copies of every line (the reference is single-process and has no analog).
"""

from __future__ import annotations

import json
import logging
import logging.handlers
import sys
import time
from pathlib import Path
from typing import Any

_CONFIGURED = False


class JsonFormatter(logging.Formatter):
    """Minimal JSON-lines formatter (stand-in for pythonjsonlogger;
    reference: configs/logging/logging.yaml:13-15)."""

    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S"),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            payload["exc_info"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(
    level: int = logging.INFO,
    log_dir: str | Path | None = None,
    json_format: bool = False,
    process_index: int = 0,
    force: bool = False,
) -> None:
    """Configure root logging: console + optional rotating files.

    Mirrors the reference dictConfig (console, 10MB x 5 rotating app log,
    separate error log — configs/logging/logging.yaml:17-38).
    """
    global _CONFIGURED
    if _CONFIGURED and not force:
        return
    root = logging.getLogger()
    root.handlers.clear()
    effective = level if process_index == 0 else max(level, logging.WARNING)
    root.setLevel(effective)

    fmt: logging.Formatter
    if json_format:
        fmt = JsonFormatter()
    else:
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
        )

    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(fmt)
    root.addHandler(console)

    if log_dir is not None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        app = logging.handlers.RotatingFileHandler(
            log_dir / "twotower.log", maxBytes=10 * 1024 * 1024, backupCount=5
        )
        app.setFormatter(fmt)
        root.addHandler(app)
        err = logging.handlers.RotatingFileHandler(
            log_dir / "errors.log", maxBytes=10 * 1024 * 1024, backupCount=5
        )
        err.setLevel(logging.ERROR)
        err.setFormatter(fmt)
        root.addHandler(err)

    # Quiet noisy third-party loggers (reference: logging.yaml:47-54).
    for noisy in ("absl", "urllib3", "filelock", "fsspec"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)


def log_retention(logger: logging.Logger, stage: str, before: int, after: int) -> None:
    """Per-stage retention stats (reference: src/data/base.py:71-76)."""
    pct = (after / before * 100.0) if before else 0.0
    logger.info("%s: %d -> %d rows (%.1f%% retained)", stage, before, after, pct)


class StageTimer:
    """Context manager logging wall-time per pipeline stage."""

    def __init__(self, logger: logging.Logger, stage: str):
        self.logger = logger
        self.stage = stage
        self.elapsed = 0.0

    def __enter__(self) -> "StageTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.elapsed = time.perf_counter() - self._t0
        self.logger.info("%s took %.3fs", self.stage, self.elapsed)

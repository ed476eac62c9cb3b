"""Tracing/profiling + failure-handling utilities (PyTorch).

The port's copy of ``twotower_tpu/utils/profiling.py``:

- ``trace(logdir)``: a ``torch.profiler`` trace (host ops and, on a GPU,
  CUDA kernels) over a code region, written as a Chrome trace into
  ``logdir``.
- ``StepTimer``: lightweight host-side step timing with percentile summary,
  cheap enough to leave on in production loops.
- ``GracefulShutdown``: SIGTERM/SIGINT handler for preemption-aware training
  — the loop checks ``should_stop`` each epoch and checkpoints before exit.
"""

from __future__ import annotations

import contextlib
import signal
import time
from pathlib import Path

import numpy as np

from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)


@contextlib.contextmanager
def trace(logdir: str | Path | None):
    """``torch.profiler`` trace over a code region, exported to
    ``logdir/trace.json``; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("profiler trace started -> %s", logdir)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(logdir / "trace.json"))
    logger.info("profiler trace written to %s", logdir / "trace.json")


class StepTimer:
    """Rolling step-duration stats (p50/p90/p99) over a bounded window."""

    def __init__(self, window: int = 1000):
        self.window = window
        self._durations: list[float] = []
        self._last: float | None = None

    def tick(self) -> float | None:
        """Mark a step boundary; returns the completed step's duration."""
        now = time.perf_counter()
        dur = None
        if self._last is not None:
            dur = now - self._last
            self._durations.append(dur)
            if len(self._durations) > self.window:
                self._durations = self._durations[-self.window :]
        self._last = now
        return dur

    def summary(self) -> dict[str, float]:
        if not self._durations:
            return {}
        arr = np.asarray(self._durations)
        return {
            "step_time_p50_ms": float(np.percentile(arr, 50) * 1000),
            "step_time_p90_ms": float(np.percentile(arr, 90) * 1000),
            "step_time_p99_ms": float(np.percentile(arr, 99) * 1000),
            "step_time_mean_ms": float(arr.mean() * 1000),
        }


class GracefulShutdown:
    """Install-once SIGTERM/SIGINT trap; training loops poll ``should_stop``.

    The first signal requests a clean stop (finish the epoch, checkpoint);
    a second signal restores default handling (hard exit).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.should_stop = False
        self._signals = signals
        self._previous: dict[int, object] = {}

    def install(self) -> "GracefulShutdown":
        for sig in self._signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        return self

    def _handle(self, signum, frame) -> None:
        if self.should_stop:  # second signal: restore default and re-raise
            signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))
            raise KeyboardInterrupt
        logger.warning(
            "received signal %s: finishing epoch then checkpointing", signum
        )
        self.should_stop = True

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

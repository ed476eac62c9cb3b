"""Tracing/profiling + failure-handling utilities (PyTorch).

The port's copy of ``twotower_tpu/utils/profiling.py``, with the port's own
spans and marks:

- ``trace(logdir)``: a ``torch.profiler`` trace (host ops and, on a GPU,
  CUDA kernels) over a code region, written as a Chrome trace into
  ``logdir``, with the spans and marks recorded in the region.
- Spans and marks (``span``, ``mark``), recorded only while tracing is
  on: inside ``trace(logdir)`` and whenever any ``torch.profiler`` records
  (torch's own process-wide flag, read on every call; there is no other
  switch). A span that is off returns one shared no-op object and makes no
  torch call. A span that is on opens a profiler range of its name
  (torch's C++ ``RecordFunction``, or ``torch.profiler.record_function``
  where torch lacks it), so that the profiler's timeline, and the device's
  idle gaps in it, carry the name on the thread the profiler watches (the
  one that started it), and appends a ``Record`` to a bounded in-memory
  buffer (``RECORD_LIMIT``; what does not fit is counted as dropped). Garbage collections are spans too
  (``gc.gen<N>``). ``snapshot()`` reads the buffer, ``reset()`` clears it.
- ``StepPhases``: CUDA timing events at the phase boundaries of a train
  step captured as a CUDA graph (``step_phase``), replayed with that graph;
  read as milliseconds of its last replay, also in ``snapshot()``.
- Counters (``counter``): float32 tensors on the device that their owner
  adds into in line with its work (``moe.routed_tokens``: each MoE layer's
  routed slots per expert), read once each by ``counters()``.
- ``StepTimer``: lightweight host-side step timing with percentile summary,
  cheap enough to leave on in production loops.
- ``GracefulShutdown``: SIGTERM/SIGINT handler for preemption-aware training
  — the loop checks ``should_stop`` each epoch and checkpoints before exit.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import gc
import itertools
import json
import signal
import threading
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.profiler
from torch.autograd import profiler as _autograd_profiler

from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

RECORD_LIMIT = 1 << 20  # records kept before dropping
STEP_PHASES = ("gather", "forward", "backward", "optimizer", "rows")
_ANCHOR = "profiling.clock_anchor"


class Record(NamedTuple):
    """One span or mark. Times are ``time.perf_counter_ns()``; ``thread``
    is the OS thread id (the profiler's ``tid``). ``parent`` of a span is
    the innermost span open in the same thread or asyncio task when it
    opened; a mark's is what its caller passes. ``request`` is the request
    or group id the caller passes."""

    name: str
    id: int
    parent: int | None
    request: int | None
    thread: int
    start_ns: int
    end_ns: int


class Recorder:
    """The buffer behind ``span`` and ``mark``, and the step's phase events
    (``register_phases``). Ids (``new_id``) are unique in the process:
    spans', marks', requests' and groups' alike.

    It takes no lock: the collector's callback adds a record from inside
    whatever code the collection interrupted, on that code's thread, so a
    lock held there would never be released. ``list.append`` and the list's
    copy hold under the interpreter lock; the limit may be passed by a
    record or two."""

    def __init__(self, limit: int = RECORD_LIMIT):
        self.limit = limit
        self.phases: StepPhases | None = None
        self.counters: dict[str, torch.Tensor] = {}
        self._ids = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        """Clear the records and zero the counters (the phase events stay:
        the graph that records them still replays)."""
        self._rows: list[tuple] = []
        self.dropped = 0
        for t in self.counters.values():
            t.zero_()

    def new_id(self) -> int:
        return next(self._ids)

    def add(self, *fields) -> None:
        """Keep one record, given as ``Record``'s fields in order."""
        if len(self._rows) < self.limit:
            self._rows.append(fields)
        else:
            self.dropped += 1

    def snapshot(self) -> dict:
        """``records`` (``Record``s) and ``dropped`` as they stand, and
        ``phases_ms``: the registered step's phases in its last timed
        replay, waited for (empty where none has run)."""
        rows, dropped = list(self._rows), self.dropped
        return {"records": list(map(Record._make, rows)), "dropped": dropped,
                "phases_ms": {} if self.phases is None else self.phases.times_ms()}


RECORDER = Recorder()
_OPEN: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "twotower_tpu_torch_open_span", default=None)
_OFF = contextlib.nullcontext()
_FAST_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _range(name: str):
    """A profiler range: torch's C++ one where it has it, which costs about
    a tenth of ``record_function``'s (a dispatched op) while the profiler
    records."""
    return torch.profiler.record_function(name) if _FAST_RANGE is None else _FAST_RANGE(name)


_THREAD = threading.local()


def _thread_id() -> int:
    """This thread's OS id, asked of the system once a thread: the call is
    a system call, which costs microseconds where system calls are
    intercepted."""
    try:
        return _THREAD.id
    except AttributeError:
        _THREAD.id = threading.get_native_id()
        return _THREAD.id


def tracing() -> bool:
    """Whether spans and marks are recorded: while a
    ``torch.profiler`` records, in any thread of the process."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start", "token", "range")

    def __init__(self, name: str, request: int | None):
        self.name, self.request = name, request

    # The bookkeeping stays outside the profiler's range: the range holds
    # the region's own work (and the range's cost), and what the records
    # cost falls between ranges.
    def __enter__(self):
        self.parent = _OPEN.get()
        self.id = RECORDER.new_id()
        self.token = _OPEN.set(self.id)
        self.range = _range(self.name)
        self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self.range.__exit__(*exc)
        _OPEN.reset(self.token)
        RECORDER.add(self.name, self.id, self.parent, self.request, _thread_id(),
                     self.start, end)


def span(name: str, *, request: int | None = None):
    """A context manager timing a region as the span ``name`` while
    tracing is on; the shared no-op context otherwise. Across an ``await``
    the profiler's range holds in time whatever other tasks run meanwhile
    (their records keep their own parents); ``mark`` records an interval
    without a range."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, request)


def mark(name: str, start_ns: int, end_ns: int, *, request: int | None = None,
         parent: int | None = None) -> None:
    """Record an interval whose ends (``time.perf_counter_ns()``) the
    caller took: one that crosses an ``await``. Kept in memory only."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.add(name, RECORDER.new_id(), parent, request, _thread_id(),
                     start_ns, end_ns)


class _Collections:
    """Garbage collections as spans ``gc.gen<N>`` while tracing is on: a
    callback the collector calls at each collection's start and stop, which
    does nothing while tracing is off. Installed once, at import."""

    def __init__(self):
        self.open = None  # (name, range, start_ns) of the collection under way

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            if _autograd_profiler._is_profiler_enabled:
                name = f"gc.gen{info['generation']}"
                rng = _range(name)
                rng.__enter__()
                self.open = (name, rng, time.perf_counter_ns())
        elif self.open is not None:
            name, rng, start = self.open
            self.open = None
            RECORDER.add(name, RECORDER.new_id(), None, None, _thread_id(),
                         start, time.perf_counter_ns())
            rng.__exit__(None, None, None)


gc.callbacks.append(_Collections())


def new_id() -> int:
    """A fresh id for a request or a group, unique among every record's."""
    return RECORDER.new_id()


def snapshot() -> dict:
    return RECORDER.snapshot()


def reset() -> None:
    RECORDER.reset()


class StepPhases:
    """Timing events at the boundaries of a captured train step's phases
    (``STEP_PHASES``; the step marks them with ``step_phase``), recorded in
    line while a graph of the step is captured (``capturing``), so that its
    replays record them again. ``replays`` counts those replays;
    ``times_ms`` turns the last one's events into milliseconds, waiting for
    its end: read it off the step's path (an epoch's end, after a trace).
    ``event`` makes one event (tests pass a fake).

    ``boundaries=None`` takes the boundaries in whatever order and number
    the step marks them, from ``gather`` to ``end`` (the sequence tower's
    step marks each layer's parts, and the gradient marks them again on
    its way back): ``times_ms`` then sums the phases of one name."""

    BOUNDARIES = (*STEP_PHASES, "end")

    def __init__(self, event=None, boundaries: tuple | None = BOUNDARIES):
        if event is None:
            event = functools.partial(torch.cuda.Event, enable_timing=True, external=True)
        self._event = event
        self.fixed = boundaries is not None
        self.names = list(boundaries) if self.fixed else []
        self.events = [event() for _ in self.names]
        self.reached = 0
        self.replays = 0

    @contextlib.contextmanager
    def capturing(self):
        """Record the boundaries the step marks in this thread, in order."""
        self.reached = 0
        if not self.fixed:
            self.names, self.events = [], []
        _CAPTURING.phases = self
        try:
            yield self
        finally:
            _CAPTURING.phases = None
        if self.fixed and self.reached != len(self.names):
            raise RuntimeError(f"the step marked {self.reached} of its "
                               f"{len(self.names)} phase boundaries")
        if not self.fixed and (self.names[:1] != ["gather"] or self.names[-1:] != ["end"]):
            raise RuntimeError(f"the step's phase boundaries {self.names} do not run from "
                               "'gather' to 'end'")

    def boundary(self, name: str) -> None:
        if self.fixed:
            want = self.names[self.reached] if self.reached < len(self.names) else None
            if name != want:
                raise RuntimeError(f"step phase boundary {name!r} where {want!r} was due")
        else:
            self.names.append(name)
            self.events.append(self._event())
        self.events[self.reached].record()
        self.reached += 1

    def times_ms(self) -> dict[str, float]:
        """Each phase's milliseconds in the last replay (empty before one),
        summed over the phases of one name."""
        if not self.replays:
            return {}
        self.events[-1].synchronize()
        out: dict[str, float] = {}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


_CAPTURING = threading.local()


def step_phase(name: str) -> None:
    """The train step's boundary before phase ``name`` (``"end"``: after
    the last): an event recorded where a ``StepPhases`` captures in this
    thread, nothing otherwise (the CPU, an eager step, the host loop)."""
    phases = getattr(_CAPTURING, "phases", None)
    if phases is not None:
        phases.boundary(name)


def counter(name: str, shape: tuple, device) -> torch.Tensor:
    """The counter ``name``: a float32 tensor of ``shape`` on ``device``,
    zero when first asked for (or when asked for at another shape or
    device), which its owner adds into on the device, in line with its
    work (a captured graph keeps adding into the same tensor). Counters
    count whether or not tracing is on; ``counters()`` reads each once, and
    ``reset()`` zeroes them."""
    t = RECORDER.counters.get(name)
    if t is None or tuple(t.shape) != tuple(shape) or t.device != torch.device(device):
        t = RECORDER.counters[name] = torch.zeros(shape, dtype=torch.float32, device=device)
    return t


def counters() -> dict[str, list]:
    """Every counter's values, read from the device once each."""
    return {k: t.tolist() for k, t in RECORDER.counters.items()}


def capturing_phases() -> StepPhases | None:
    """The ``StepPhases`` capturing in this thread, if any."""
    return getattr(_CAPTURING, "phases", None)


def register_phases(phases: StepPhases) -> None:
    """Make ``phases`` the step ``snapshot()`` reads."""
    RECORDER.phases = phases


@contextlib.contextmanager
def trace(logdir: str | Path | None):
    """``torch.profiler`` trace over a code region, exported to
    ``logdir/trace.json`` with the region's spans and marks (process 0, a
    row a thread; their clock placed on the profiler's by an anchor range);
    no-op when logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logger.info("profiler trace started -> %s", logdir)
    with profile(activities=activities) as prof:
        first = RECORDER.new_id()  # ids grow: the region's records come after it
        before = time.perf_counter_ns()
        with torch.profiler.record_function(_ANCHOR):
            pass
        after = time.perf_counter_ns()
        yield
    path = logdir / "trace.json"
    prof.export_chrome_trace(str(path))
    records = [r for r in RECORDER.snapshot()["records"] if r.id > first]
    _add_records(path, records, (before + after) / 2)
    logger.info("profiler trace written to %s (%d spans and marks)", path, len(records))


def _add_records(path: Path, records: list[Record], anchor_ns: float) -> None:
    data = json.loads(path.read_text())
    events = data["traceEvents"]
    anchor = next(e for e in events if e.get("name") == _ANCHOR)
    offset_us = anchor["ts"] + anchor.get("dur", 0.0) / 2 - anchor_ns / 1e3
    events.append({"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
                   "args": {"name": "spans and marks"}})
    events.extend({"ph": "X", "cat": "span", "name": r.name, "pid": 0, "tid": r.thread,
                   "ts": r.start_ns / 1e3 + offset_us, "dur": (r.end_ns - r.start_ns) / 1e3,
                   "args": {"id": r.id, "parent": r.parent, "request": r.request}}
                  for r in records)
    path.write_text(json.dumps(data))


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

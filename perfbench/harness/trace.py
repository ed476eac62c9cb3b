"""A window under ``torch.profiler``, reduced in memory to what the metrics
read: device time by operation name, device time under each span the harness
opened, the device's busy time, and its idle gaps named by what the host was
doing. Nothing is written to disk.

A span is a ``torch.profiler.record_function`` range the harness opens
around a call into a layer (``SPAN_PREFIX`` + name); its device time is the
time of the kernels launched inside it.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

WINDOW = "perfbench.window"
SPAN_PREFIX = "perfbench."
NAMED_GAPS = 500  # gaps named by host activity; shorter ones are summed as one
TOP = 10


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals clipped to
    ``[lo, hi]``."""
    total, reach = 0.0, lo
    for start, end in sorted(intervals):
        start, end = max(start, reach), min(end, hi)
        if end > start:
            total += end - start
            reach = end
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of ``[lo, hi]`` that no interval covers."""
    gaps, reach = [], lo
    for start, end in sorted(intervals):
        if start > reach:
            gaps.append((reach, min(start, hi)))
        reach = max(reach, end)
        if reach >= hi:
            break
    if reach < hi:
        gaps.append((reach, hi))
    return [(a, b) for a, b in gaps if b > a]


@dataclass
class Trace:
    """A traced window reduced: seconds throughout."""

    window_s: float
    busy_s: float
    device_ops: dict[str, list] = field(default_factory=dict)  # name -> [seconds, count]
    spans: dict[str, list] = field(default_factory=dict)  # name -> [device seconds, count]
    gaps: dict[str, float] = field(default_factory=dict)  # host activity -> idle seconds

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_s(self, *parts: str) -> tuple[float, int]:
        """Device seconds and count of the operations whose name holds any
        of ``parts``."""
        hits = [v for k, v in self.device_ops.items() if any(p in k for p in parts)]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v[0]] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation


def summarize(events, window_name: str = WINDOW) -> Trace:
    """Reduce the profiler's events (``prof.events()``, or objects with the
    same fields) to a ``Trace``. Times are the profiler's microseconds."""
    cpu_type = torch.autograd.DeviceType.CPU
    window = [e for e in events if e.device_type == cpu_type and e.name == window_name]
    if len(window) != 1:
        raise RuntimeError(f"{len(window)} {window_name} ranges in the trace")
    lo, hi = window[0].time_range.start, window[0].time_range.end
    device = [e for e in events if _is_device(e)]
    intervals = [(e.time_range.start, e.time_range.end) for e in device]
    trace = Trace(window_s=(hi - lo) / 1e6, busy_s=union_length(intervals, lo, hi) / 1e6)
    for e in device:
        slot = trace.device_ops.setdefault(e.name, [0.0, 0])
        slot[0] += (e.time_range.end - e.time_range.start) / 1e6
        slot[1] += 1
    host = sorted(
        (e for e in events if e.device_type == cpu_type and not e.is_async
         and e.name != window_name),
        key=lambda e: e.time_range.start,
    )
    for e in host:
        if e.name.startswith(SPAN_PREFIX):
            slot = trace.spans.setdefault(e.name[len(SPAN_PREFIX):], [0.0, 0])
            slot[0] += e.device_time_total / 1e6
            slot[1] += 1
    starts = [e.time_range.start for e in host]
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
    for a, b in gaps[:NAMED_GAPS]:
        mid, best = (a + b) / 2, None
        for e in reversed(host[max(0, bisect.bisect_right(starts, mid) - 4000):
                               bisect.bisect_right(starts, mid)]):
            if e.time_range.end >= mid and (
                    best is None or e.time_range.end - e.time_range.start
                    < best.time_range.end - best.time_range.start):
                best = e
        name = "host: no profiled op" if best is None else f"host: {best.name}"
        trace.gaps[name] = trace.gaps.get(name, 0.0) + (b - a) / 1e6
    rest = sum(b - a for a, b in gaps[NAMED_GAPS:])
    if rest:
        trace.gaps["shorter gaps"] = rest / 1e6
    return trace


def traced(fn):
    """Run ``fn()`` under the profiler (host ops and CUDA activity) inside
    one ``WINDOW`` range that ends after the device has finished; returns
    ``(fn's result, Trace, seconds spent reducing the trace)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    t = time.perf_counter()
    trace = summarize(prof.events())
    return out, trace, time.perf_counter() - t


def span(name: str):
    """A range the trace reads as the span ``name``."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)

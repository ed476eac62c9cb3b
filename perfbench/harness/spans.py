"""What the program's own tracing kept of the traced window
(``twotower_tpu_torch.utils.profiling.snapshot()``: spans, marks
and the captured step's phase times), read by the per-layer metrics that
name ``program_span`` as their source. The harness turns the program's
tracing on by running the window under ``torch.profiler``; nothing here
changes what is recorded. A program without that tracing reads as ``None``,
and every metric then reports nothing."""

from __future__ import annotations

import statistics


def snapshot() -> dict | None:
    """The program's snapshot, or None where the program keeps none."""
    try:
        from twotower_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "snapshot", None)
    return None if read is None else read()


def named(snap: dict | None, *names: str) -> list:
    """The records (spans and marks) named any of ``names``."""
    if not snap:
        return []
    return [r for r in snap.get("records", []) if r.name in names]


def median_ms(snap: dict | None, name: str) -> float | None:
    """Median length in ms of the records named ``name``."""
    ms = [(r.end_ns - r.start_ns) / 1e6 for r in named(snap, name)]
    return statistics.median(ms) if ms else None


def union_ns(records) -> int:
    """Length of the union of the records' intervals (nested spans once)."""
    total, reach = 0, None
    for r in sorted(records, key=lambda r: r.start_ns):
        start = r.start_ns if reach is None else max(r.start_ns, reach)
        if r.end_ns > start:
            total += r.end_ns - start
            reach = r.end_ns
    return total


def calls(snap: dict | None, first: str, last: str, names: tuple) -> list[dict]:
    """The calls a thread made of one traced function whose spans tile it:
    each from a ``first`` span to the next ``last`` span on its thread,
    the ``names`` spans between summed by name in ns. A call the window cut
    (a span missing) is left out."""
    out = []
    by_thread: dict[int, list] = {}
    for r in named(snap, first, last, *names):
        by_thread.setdefault(r.thread, []).append(r)
    for recs in by_thread.values():
        call = None
        for r in sorted(recs, key=lambda r: r.start_ns):
            if r.name == first:
                call = {}
            if call is None:
                continue
            if r.name in names:
                call[r.name] = call.get(r.name, 0) + r.end_ns - r.start_ns
            if r.name == last:
                if set(call) == set(names):
                    out.append(call)
                call = None
    return out


def phase_ms(phase: str) -> float | None:
    """The captured train step's ``phase`` in the last replay of its timed
    graph (``training/device_loop.py``), in ms."""
    snap = snapshot()
    return None if not snap else snap.get("phases_ms", {}).get(phase)

"""Median time from a device call's return (in the executor thread) to the
next group's dispatch in the traced window: the ``batcher.dispatch_gap``
marks of the ``MicroBatcher`` (``serving/api.py``), the event loop's
turnaround between two calls."""

from perfbench.harness.spans import median_ms, snapshot


def read(ctx):
    return median_ms(snapshot(), "batcher.dispatch_gap")

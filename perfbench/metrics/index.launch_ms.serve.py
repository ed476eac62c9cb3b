"""Median host ms a ``RetrievalIndex.recommend`` call spends before it
waits for the device, in the traced window: its ``index.h2d``,
``index.user_tower`` and ``index.search`` spans (``serving/index.py``; the
fourth, ``index.d2h``, is the wait and the copy back)."""

import statistics

from perfbench.harness.spans import calls, snapshot

LAUNCH = ("index.h2d", "index.user_tower", "index.search")


def read(ctx):
    found = calls(snapshot(), "index.h2d", "index.d2h", LAUNCH)
    return statistics.median(sum(c.values()) / 1e6 for c in found) if found else None

"""Median time a request waited in the ``MicroBatcher``'s queue in the
traced window: its ``batcher.queue_wait`` mark, from ``submit`` to the
dispatch of the group that served it (``serving/api.py``)."""

from perfbench.harness.spans import median_ms, snapshot


def read(ctx):
    return median_ms(snapshot(), "batcher.queue_wait")

"""Event-loop time a completed request costs in the traced window: the
union of the ``serve.*`` spans (``CoalescedRoutes.recommend``: prepare,
filter, format) and the ``batcher.collect`` and ``batcher.scatter`` spans
(``MicroBatcher``), over the requests formatted (``serve.format``)."""

from perfbench.harness.spans import named, snapshot, union_ns

HOST = ("serve.prepare", "serve.filter", "serve.format", "batcher.collect", "batcher.scatter")


def read(ctx):
    snap = snapshot()
    done = len(named(snap, "serve.format"))
    return union_ns(named(snap, *HOST)) / 1e3 / done if done else None

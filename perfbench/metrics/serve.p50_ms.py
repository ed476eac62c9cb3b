"""Median latency of every request due in the window, timed from when it
was due."""


def read(ctx):
    return ctx.layer.get("p50_ms")

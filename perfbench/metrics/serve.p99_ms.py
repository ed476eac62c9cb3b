"""99th percentile latency of every request due in the window, timed from
when it was due (a failed request counts as missing). Above the knee the
queue grows all through the window, so it swings with the smallest change:
a per-layer reading, not a bound."""


def read(ctx):
    return ctx.layer.get("p99_ms")

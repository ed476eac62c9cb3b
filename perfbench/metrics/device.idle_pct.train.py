"""Share of the traced window in which no operation ran on the device (the
union of the profiler's device intervals against the window's length)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0:
        return None
    return ctx.trace.idle_pct

"""Requests served a device call: the window's completed requests over the
``MicroBatcher``'s count of the calls it issued (``MicroBatcher.batches``)."""


def read(ctx):
    return ctx.layer.get("rows_per_call")

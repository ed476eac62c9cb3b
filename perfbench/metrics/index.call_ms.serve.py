"""Median host time of one ``RetrievalIndex.recommend`` call (it returns
numpy, so the call has ended on the device), by a thin wrapper around the
index the harness hands the service."""


def read(ctx):
    return ctx.layer.get("index_call_ms")

"""Median device time of one replay of the captured train step, by CUDA
events around single ``step()`` calls of the device loop (traced run, after
the window)."""


def read(ctx):
    return ctx.layer.get("replay_ms")

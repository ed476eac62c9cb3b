"""Share of the traced evaluation's searches that took the exact two-pass
search's float32 block-maxima prefilter kernels: 100 x the program's
``search.twopass_prefilter`` spans (``ops/topk.py::topk_mips_twopass``, one
a call through the kernels) over the harness's ``search`` spans (one around
each search call, ``drivers/evaluate.py``). Nothing where the program opens
no such span."""

from perfbench.harness.spans import named, snapshot


def read(ctx):
    taken = len(named(snapshot(), "search.twopass_prefilter"))
    searches = ctx.trace.spans.get("search", (0.0, 0))[1]
    if not taken or not searches:
        return None
    return 100.0 * taken / searches

"""Share of the traced evaluation's searches that took the approx search's
block-maxima prefilter over a bfloat16 corpus: 100 x the program's
``search.prefilter`` spans (``ops/topk.py::topk_mips_approx``, one a call
on that path) over the harness's ``search`` spans (one around each search
call, ``drivers/evaluate.py``). Nothing where the program opens no such
span."""

from perfbench.harness.spans import named, snapshot


def read(ctx):
    taken = len(named(snapshot(), "search.prefilter"))
    searches = ctx.trace.spans.get("search", (0.0, 0))[1]
    if not taken or not searches:
        return None
    return 100.0 * taken / searches

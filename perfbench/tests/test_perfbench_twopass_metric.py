"""``search.twopass_kernel_pct.eval``: the share of the traced evaluation's
searches that opened the program's ``search.twopass_prefilter`` span, on
snapshots made by hand."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench.harness.manifest import load_module
from twotower_tpu_torch.utils import profiling
from twotower_tpu_torch.utils.profiling import Record

BENCH = Path(__file__).resolve().parents[1]
MS = 1_000_000


def reader():
    return load_module(BENCH / "metrics" / "search.twopass_kernel_pct.eval.py",
                       "t_search_twopass_kernel_pct_eval")


def rec(name, start_ms, end_ms):
    return Record(name, 0, None, None, 1, int(start_ms * MS), int(end_ms * MS))


@pytest.mark.parametrize("snap", ["every_search", "quarter", "other_spans", "empty",
                                  "no_snapshot"])
def test_twopass_share_reads_the_spans_over_the_harness_searches(monkeypatch, snap):
    """100 where each of the traced call's 16 searches opened
    ``search.twopass_prefilter``, 25 where 4 did, nothing where the program
    opened only other spans (the bfloat16 prefilter's), none, or keeps no
    snapshot."""
    if snap == "no_snapshot":
        monkeypatch.delattr(profiling, "snapshot")
    else:
        taken = {"every_search": 16, "quarter": 4, "other_spans": 0, "empty": 0}[snap]
        records = [rec("search.twopass_prefilter", 10 * i, 10 * i + 9) for i in range(taken)]
        if snap == "other_spans":
            records = [rec("search.prefilter", 10 * i, 10 * i + 9) for i in range(16)]
        monkeypatch.setattr(profiling, "snapshot",
                            lambda: {"records": records, "dropped": 0, "phases_ms": {}})
    ctx = SimpleNamespace(trace=SimpleNamespace(spans={"search": [1.5, 16]}))
    got = reader().read(ctx)
    assert got == {"every_search": 100.0, "quarter": 25.0}.get(snap)


def test_nothing_without_the_harness_searches(monkeypatch):
    records = [rec("search.twopass_prefilter", 0, 9)]
    monkeypatch.setattr(profiling, "snapshot",
                        lambda: {"records": records, "dropped": 0, "phases_ms": {}})
    assert reader().read(SimpleNamespace(trace=SimpleNamespace(spans={}))) is None

"""Evaluation through ``evaluation/evaluator.py::Evaluator.evaluate``: the
corpus encode, the user tower, the search (``ops/topk.py``: the approx
search over a bfloat16 corpus for per-epoch validation, or the exact
two-pass search over a float32 corpus for ``evaluate-model``) and the metric
sums, as the train CLI's validation and ``evaluate-model`` call it.

Set-up makes planted weights (``harness/weights.py``) and the rows
(``users`` and ``items`` id distributions) from the seed, the rows on the
host as the CLIs hand them over, and warms the call once at the batch and
the ragged last batch the window uses. The window runs whole calls of
``rows`` back to back. The check reads the top-k of a sample of the last
call's rows, drawn from the seed, where the search hands them to the
metrics, and the call's metrics; the reference ranks every row again.

The search and the precision of the scores are the configuration's
(``retrieval.eval_exact``: the two-pass search, else the approx one;
``retrieval.eval_corpus_dtype``), with the traffic's overrides: the trace
times that search, the reference scores at that precision and the control
at the one below it (``harness/program.py``).

Traffic keys: ``rows``, ``users``, ``items``, ``weights``, ``overrides``
(the configuration's settings this path runs with), ``sampled_rows``,
``trace_rows`` (the rows of the traced call) and ``check`` (the limits).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.harness import traffic as tr
from perfbench.harness import weights as wt
from perfbench.harness.program import control_of, model_of, program_config
from perfbench.harness.trace import span, traced
from perfbench.reference import search_ref

SEARCHES = {"approx": "topk_mips_approx", "twopass": "topk_mips_twopass"}
ROWS_A_BLOCK = 2048  # the reference's rows a block: [2048, items] float32 scores


@dataclass
class Eval:
    cfg: object
    device: torch.device
    evaluator: object
    params: dict
    users: np.ndarray
    items: np.ndarray
    sample: np.ndarray
    seen: dict = field(default_factory=dict)


class TopkSpy:
    """Keeps the top-k lists of the sampled rows of each call, read where
    the evaluator hands its search's result to the metrics."""

    def __init__(self, metrics_at_k, sample: np.ndarray):
        self.inner = metrics_at_k
        self.sample = sample
        self.kept: list[torch.Tensor] = []
        self.offset = 0

    def reset(self) -> None:
        self.kept, self.offset = [], 0

    def __call__(self, topk_idx, true_item, ks, **kw):
        lo, n = self.offset, topk_idx.shape[0]
        a, b = np.searchsorted(self.sample, [lo, lo + n])
        if b > a:
            local = torch.as_tensor(self.sample[a:b] - lo, device=topk_idx.device)
            self.kept.append(topk_idx.index_select(0, local))
        self.offset += n
        return self.inner(topk_idx, true_item, ks, **kw)


def setup(run) -> Eval:
    from twotower_tpu_torch.evaluation import evaluator as ev

    t = run.cell.traffic
    cfg = program_config(run)
    dev = torch.device(run.device)
    run.mark("program")
    c = run.cell.config
    params = wt.make_params(t["weights"], run.seed, c["num_users"], c["num_items"],
                            model_of(cfg), dev)
    run.mark("weights")
    rows = int(t["rows"])
    users = tr.draw_ids(t["users"], rows, c["num_users"], run.seed, tr.USERS, dev)
    items = tr.draw_ids(t["items"], rows, c["num_items"], run.seed, tr.ITEMS, dev, users=users)
    sample = tr.sample_indices(rows, int(t["sampled_rows"]), run.seed)
    run.mark("rows")
    evaluator = ev.Evaluator(cfg, c["num_items"], device=dev)
    spy = TopkSpy(ev.metrics_at_k, sample)
    ev.metrics_at_k = spy
    obj = Eval(cfg=cfg, device=dev, evaluator=evaluator, params=params,
               users=users.cpu().numpy(), items=items.cpu().numpy(), sample=sample)
    obj.seen["spy"] = spy
    warm = min(rows, evaluator.batch_size + rows % evaluator.batch_size)
    evaluator.evaluate(params, obj.users[:warm], obj.items[:warm])
    spy.reset()
    run.mark("warm-up")
    return obj


def _call(obj: Eval, rows: int | None = None) -> dict:
    obj.seen["spy"].reset()
    n = len(obj.users) if rows is None else rows
    return obj.evaluator.evaluate(obj.params, obj.users[:n], obj.items[:n])


def window(obj: Eval, seconds: float) -> dict:
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        obj.seen["metrics"] = _call(obj)
        calls += 1
    elapsed = time.perf_counter() - t0  # the call returns host floats: the device is done
    obj.seen["topk"] = torch.cat(obj.seen["spy"].kept).cpu()  # the last call's sample
    return {"e2e": {"eval_rows_per_s": calls * len(obj.users) / elapsed},
            "attempted": calls, "failed": 0,
            "layer": {"window_calls": calls,
                      "search_dtype": obj.cfg.retrieval.eval_corpus_dtype}}


def trace(obj: Eval, run) -> tuple[dict, object]:
    """One call over ``trace_rows`` rows under the profiler, each search
    inside the span ``search``."""
    from twotower_tpu_torch.evaluation import evaluator as ev

    name = SEARCHES["twopass" if obj.cfg.retrieval.eval_exact else "approx"]
    inner = getattr(ev, name)
    batches: list[int] = []

    def timed(query, *args, **kw):
        batches.append(int(query.shape[0]))
        with span("search"):
            return inner(query, *args, **kw)

    setattr(ev, name, timed)
    try:
        _, trace, reduce_s = traced(lambda: _call(obj, int(run.cell.traffic["trace_rows"])))
    finally:
        setattr(ev, name, inner)
    return {"search_batches": batches, "reduce_s": reduce_s}, trace


def release(obj: Eval) -> dict:
    from twotower_tpu_torch.evaluation import evaluator as ev

    spy = obj.seen["spy"]
    ev.metrics_at_k = spy.inner
    kept = {"cfg": obj.cfg, "users": obj.users, "items": obj.items, "sample": obj.sample,
            "topk": obj.seen["topk"], "metrics": obj.seen["metrics"]}
    obj.evaluator = obj.params = None
    if obj.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return kept


def _reference(kept: dict, run, precision: str):
    """The reference at ``precision`` over the weights made again from the
    seed: its scorer, its metric sums over every row, and the sampled rows'
    queries."""
    t, c = run.cell.traffic, run.cell.config
    cfg, dev = kept["cfg"], torch.device(run.device)
    params = wt.make_params(t["weights"], run.seed, c["num_users"], c["num_items"],
                            model_of(cfg), dev)
    dtype = getattr(torch, cfg.model.compute_dtype)
    scorer = search_ref.Scorer(search_ref.encode(
        params["item_tower"], params["item_embedding"][:c["num_items"]], dtype), precision)
    users = torch.as_tensor(kept["users"], device=dev)
    items = torch.as_tensor(kept["items"], device=dev)
    sums = None
    for lo in range(0, len(users), ROWS_A_BLOCK):
        q = search_ref.encode(params["user_tower"],
                              params["user_embedding"][users[lo:lo + ROWS_A_BLOCK]], dtype)
        part = search_ref.metric_sums(search_ref.ranks(scorer, q, items[lo:lo + ROWS_A_BLOCK]),
                                      cfg.retrieval.top_k_eval)
        sums = part if sums is None else {k: sums[k] + v for k, v in part.items()}
    sample = torch.as_tensor(kept["sample"], device=dev)
    q = search_ref.encode(params["user_tower"], params["user_embedding"][users[sample]], dtype)
    return scorer, sums, q


def readings(kept: dict, run, served: torch.Tensor, metrics: dict) -> dict[str, float]:
    """The numbers the check compares, of ``served`` top-k lists of the
    sampled rows and a call's ``metrics``, against the reference at the
    configuration's precision of the scores: the widest gap by which a served id
    scores below the k-th best, the rows whose lists are not k distinct
    ids, and the widest gap between the metric means."""
    scorer, sums, q = _reference(kept, run, kept["cfg"].retrieval.eval_corpus_dtype)
    k = max(kept["cfg"].retrieval.top_k_eval)
    gap = search_ref.served_gap(scorer, q, served.to(q.device), k)
    return {"topk_gap": gap["gap"], "bad_rows": float(gap["bad_rows"]),
            "metric_gap": search_ref.gap_of_metrics(metrics, sums, len(kept["users"]))}


def check(kept: dict, run) -> dict[str, float]:
    return readings(kept, run, kept["topk"], kept["metrics"])


def control(kept: dict, run) -> dict[str, float]:
    """The control's readings: the reference at the precision below the
    configuration's (``harness/program.py``) put in the program's place, its
    top-k of the sampled rows and its metrics, against the reference."""
    low, sums, q = _reference(kept, run, control_of(kept["cfg"].retrieval.eval_corpus_dtype))
    served = search_ref.topk(low, q, max(kept["cfg"].retrieval.top_k_eval), ids=True)[1].cpu()
    del low
    metrics = {k: v / len(kept["users"]) for k, v in sums.items()}
    return readings(kept, run, served, metrics)

"""Serving through ``serving/api.py::CoalescedRoutes.recommend`` under
asyncio over a ``RecommendService`` and its ``MicroBatcher``: the path the
HTTP front (``create_app``) wraps, driven without HTTP.

Set-up makes the weights on the device from the seed, builds the
``RetrievalIndex`` (the corpus encoded, quantised to the configuration's
``serving.corpus_dtype`` and held on the card), a vocabulary of every user
and item id as strings (the service names its items in each response), the
service, and warms the recommend batcher's buckets at the served ``k``. The
index the service gets is wrapped so that the host time of each
``RetrievalIndex.recommend`` call is kept.

The window is an open loop: requests of one user each, due at Poisson
arrivals from the seed at the traffic's fixed ``rate``, are sent when due
whatever is still in flight, and each is timed from when it was due. The
rate lies above what the service sustains, so the queue grows all through
the window: the end-to-end metric is the requests completed within the
window a second, and the latencies, which swing with the smallest change
there, are per-layer metrics. A request that fails or never returns counts
as missing. Once the window has closed and the queue has drained, a sample
of the requests drawn from the seed is checked against the reference: the
user tower, the corpus encode, the quantisation and the top-k each response
carries.

The reference scores at the configuration's ``serving.corpus_dtype``, the
control at the precision below it (``harness/program.py``).

Traffic keys: ``rate``, ``users``, ``k``, ``weights``, ``sampled_requests``,
``trace_seconds``, ``drain_seconds`` and ``check`` (the limits).
"""

from __future__ import annotations

import asyncio
import math
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.harness import stats
from perfbench.harness import traffic as tr
from perfbench.harness import weights as wt
from perfbench.harness.program import control_of, model_of, program_config
from perfbench.harness.trace import traced
from perfbench.reference import search_ref


class TimedIndex:
    """The index the service is handed: ``recommend`` timed by the host
    clock (it returns numpy, so each call has ended on the device), every
    other attribute the index's own."""

    def __init__(self, index):
        self._index = index
        self.calls_ms: list[float] = []

    def recommend(self, user_idx, k: int = 100):
        t = time.perf_counter()
        out = self._index.recommend(user_idx, k)
        self.calls_ms.append((time.perf_counter() - t) * 1e3)
        return out

    def __getattr__(self, name):
        return getattr(self._index, name)


@dataclass
class Serve:
    cfg: object
    device: torch.device
    routes: object
    index: TimedIndex
    users: np.ndarray
    due: np.ndarray
    sample: np.ndarray
    k: int
    drain_s: float
    seen: dict = field(default_factory=dict)


def _vocab(num_users: int, num_items: int):
    from twotower_tpu_torch.data.vocab import Vocabulary, VocabPair

    def ids(prefix: str, n: int) -> np.ndarray:
        out = np.empty(n, dtype=object)
        out[:] = [f"{prefix}{i}" for i in range(n)]
        return out

    return VocabPair(users=Vocabulary(ids("U", num_users), np.ones(num_users, np.int64)),
                     items=Vocabulary(ids("I", num_items), np.ones(num_items, np.int64)))


def setup(run) -> Serve:
    from twotower_tpu_torch.serving.api import CoalescedRoutes, RecommendService
    from twotower_tpu_torch.serving.index import RetrievalIndex

    t, c = run.cell.traffic, run.cell.config
    cfg = program_config(run)
    dev = torch.device(run.device)
    run.mark("program")
    params = wt.make_params(t["weights"], run.seed, c["num_users"], c["num_items"],
                            model_of(cfg), dev)
    run.mark("weights")
    index = TimedIndex(RetrievalIndex(cfg, params, c["num_users"], c["num_items"], device=dev))
    del params
    run.mark("index")
    vocab = _vocab(c["num_users"], c["num_items"])
    run.mark("vocabulary")
    service = RecommendService(
        index, vocab, default_k=cfg.serving.top_k,
        max_batch=cfg.serving.max_batch_size, max_exclude=cfg.serving.max_exclude,
        max_history=cfg.serving.max_history)
    routes = CoalescedRoutes(service, window_ms=cfg.serving.coalesce_window_ms)
    k = int(t["k"])
    routes.batchers["recommend"].warmup(k)
    run.mark("warm-up")
    due = tr.poisson_arrivals(float(t["rate"]), run.seconds, run.seed)
    users = tr.draw_ids(t["users"], len(due), c["num_users"], run.seed, tr.USERS,
                        dev).cpu().numpy()
    sample = tr.sample_indices(len(due), int(t["sampled_requests"]), run.seed)
    index.calls_ms.clear()
    return Serve(cfg=cfg, device=dev, routes=routes, index=index, users=users, due=due,
                 sample=sample, k=k, drain_s=float(t["drain_seconds"]))


async def _open_loop(routes, due: np.ndarray, users: np.ndarray, k: int, keep: set,
                     drain_s: float):
    """Send request ``i`` at ``due[i]`` seconds from the start; returns each
    request's latency from its due time (inf where it failed or never
    returned), how late each was sent, the kept responses and the wall
    time."""
    loop = asyncio.get_running_loop()
    n = len(due)
    latency = np.full(n, math.inf)
    late = np.zeros(n)
    kept: dict[int, dict] = {}
    errors: list[str] = []
    t0 = loop.time()

    async def one(i: int):
        try:
            out = await routes.recommend({"user_idx": [int(users[i])], "k": k})
        except Exception as e:  # a failed request counts as missing
            errors.append(f"{type(e).__name__}: {e}")
            return
        latency[i] = loop.time() - (t0 + due[i])
        if i in keep:
            kept[i] = out

    in_flight: set = set()  # a reference to each task until it is done, and no longer
    for i in range(n):
        delay = t0 + due[i] - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        late[i] = loop.time() - (t0 + due[i])
        task = loop.create_task(one(i))
        in_flight.add(task)
        task.add_done_callback(in_flight.discard)
    close = loop.time()
    if in_flight:
        _, pending = await asyncio.wait(set(in_flight), timeout=drain_s)
        for p in pending:
            p.cancel()
        await asyncio.gather(*pending, return_exceptions=True)
    return latency, late, kept, errors, loop.time() - t0, close - t0


def _drive(obj: Serve, due, users, keep: set, drain_s: float):
    batcher = obj.routes.batchers["recommend"]
    before = batcher.batches
    obj.index.calls_ms.clear()
    out = asyncio.run(_open_loop(obj.routes, due, users, obj.k, keep, drain_s))
    return out, batcher.batches - before


def window(obj: Serve, seconds: float) -> dict:
    (latency, late, kept, errors, wall, _), calls = _drive(
        obj, obj.due, obj.users, set(obj.sample.tolist()), obj.drain_s)
    obj.seen["kept"] = kept
    done = np.isfinite(latency)
    ms = latency * 1e3
    print(f"generator lateness: p50 {np.percentile(late, 50) * 1e3:.3f} ms, p99 "
          f"{np.percentile(late, 99) * 1e3:.3f} ms, max {late.max() * 1e3:.3f} ms over "
          f"{len(late)} requests due in {seconds} s", file=sys.stderr)
    if errors:
        print(f"{len(errors)} requests failed, the first: {errors[0]}", file=sys.stderr)
    in_window = int((obj.due + latency <= seconds).sum())  # inf (missing) never counts
    layer = {"p50_ms": stats.percentile(ms, 50), "p99_ms": stats.percentile(ms, 99),
             "rows_per_call": int(done.sum()) / max(calls, 1),
             "index_call_ms": statistics.median(obj.index.calls_ms) if obj.index.calls_ms
             else None, "wall_s": wall}
    return {"e2e": {"serve_requests_per_s": in_window / seconds}, "attempted": len(latency),
            "failed": int((~done).sum()), "layer": layer}


def trace(obj: Serve, run) -> tuple[dict, object]:
    """The open loop's first ``trace_seconds`` again, under the profiler."""
    span_s = float(run.cell.traffic["trace_seconds"])
    head = obj.due < span_s
    _, trace, reduce_s = traced(lambda: _drive(obj, obj.due[head], obj.users[head], set(),
                                                obj.drain_s))
    return {"reduce_s": reduce_s}, trace


def release(obj: Serve) -> dict:
    kept = obj.seen["kept"]
    order = sorted(kept)
    rows = [kept[i]["results"][0] for i in order]
    out = {"cfg": obj.cfg, "users": obj.users[order], "k": obj.k,
           "ids": torch.tensor([r["item_idx"] for r in rows], dtype=torch.long),
           "scores": torch.tensor([r["scores"] for r in rows], dtype=torch.float32),
           "missing": len(obj.sample) - len(order),
           "wrong_user": sum(int(r["user_idx"]) != int(u) for r, u in zip(rows, obj.users[order]))}
    obj.routes = obj.index = None
    if obj.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return out


def _reference(kept: dict, run, precision: str):
    t, c = run.cell.traffic, run.cell.config
    cfg, dev = kept["cfg"], torch.device(run.device)
    params = wt.make_params(t["weights"], run.seed, c["num_users"], c["num_items"],
                            model_of(cfg), dev)
    dtype = getattr(torch, cfg.model.compute_dtype)
    users = torch.as_tensor(kept["users"], device=dev)
    q = search_ref.encode(params["user_tower"], params["user_embedding"][users], dtype)
    items = params.pop("item_embedding")[:c["num_items"]]
    tower = params["item_tower"]
    del params
    scorer = search_ref.Scorer(search_ref.encode(tower, items, dtype), precision)
    return scorer, q


def readings(kept: dict, run, ids: torch.Tensor, scores: torch.Tensor) -> dict[str, float]:
    """The numbers the check compares, of the served ids and scores against
    the reference at ``serving.corpus_dtype``: the widest gap by which a
    served id scores below the k-th best, the widest gap between a served
    score and the reference's score of that id, and the answers that are
    missing or not k distinct ids of the corpus for the user asked."""
    scorer, q = _reference(kept, run, kept["cfg"].serving.corpus_dtype)
    gap = search_ref.served_gap(scorer, q, ids.to(q.device), kept["k"])
    score_gap = float((gap["scores"] - scores.to(q.device)).abs().max()) if len(ids) else 0.0
    bad = gap["bad_rows"] + kept["missing"] + kept["wrong_user"]
    return {"topk_gap": gap["gap"], "score_gap": score_gap, "bad_answers": float(bad)}


def check(kept: dict, run) -> dict[str, float]:
    return readings(kept, run, kept["ids"], kept["scores"])


def control(kept: dict, run) -> dict[str, float]:
    """The control's readings: the reference at the precision below
    ``serving.corpus_dtype`` (int4 for the configuration's int8) put in the program's place for the sampled
    requests, against the reference."""
    low, q = _reference(kept, run, control_of(kept["cfg"].serving.corpus_dtype))
    scores, ids = search_ref.topk(low, q, kept["k"], ids=True)
    del low
    return readings(kept, run, ids.cpu(), scores.cpu())

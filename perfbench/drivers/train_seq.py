"""Training the sequence user tower (``model.user_tower: sequence``) through
the device loop: ``training/device_loop.py::make_epoch_fn``'s program, the
path ``train-model`` takes for it, one packed stream of user windows a
step, without validation or saves.

Traffic: each stream holds ``stream`` slots of windows whose lengths are
drawn from ``window`` (Zipf over ``[min, max]``), the stream's last window
cut to fit. A window of ``L`` slots takes ``L + 1`` consecutive items of
one draw of ``items`` (``harness/traffic.py``'s ``catalog_drift`` law):
slot ``t`` reads item ``t`` and is scored against item ``t + 1``. An epoch
is ``streams_per_epoch`` streams; log q comes from every drawn item.

Set-up fails within seconds on a program without the sequence tower (its
module missing, or a ``Config`` that does not keep ``model.user_tower``):
such a program would train another model under this cell's name. Then it
makes the weights on the device from the seed
(``reference/seq_train_ref.py::make_params``) and the epoch's columns, reads
the program's own routing of the first stream at the initial weights, and
runs the first epoch and the first step of the next through ``step()``: on a
card two warm-up steps, the capture of the CUDA graph, then replays. It
reads what the check needs as it goes, as norms (the state is too large to
keep a copy on the card): each step's loss; after the first step each
dense leaf's gradient (from Adam's first moment) and the first step's item
rows'; after the third the change of each leaf and of the rows the three
steps read; around the watched step (the first after the epoch's end) the
same, the state before it kept in host memory for the reference. The
window replays steps, epochs back to back.

The check runs the reference (float32, TF32 off, over blocks of about
``reference_block`` slots cut at window starts) from the weights made again
through the first three steps, and from the kept state through the watched
step, and compares: the worst step's loss gap, the worst leaf's gap of the
first gradient's norm and of the change's norm (c3_train's measures), the
same over the watched step, and the share of (slot, MoE layer) pairs whose
expert set differs from the reference's at the initial weights.

Traffic keys: ``stream``, ``streams_per_epoch``, ``window``, ``items``,
``reference_block``, ``trace_seconds``, ``replays_timed`` and ``check``.
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from perfbench.harness import traffic as tr
from perfbench.harness.program import control_of, program_config
from perfbench.harness.trace import traced
from perfbench.reference import seq_train_ref as ref

CHECKED_STEPS = 3
B1 = 0.9
LENGTHS = 7  # the window lengths' stream of the run's generators
DENSE = ("item_tower", "seq_tower")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _require_sequence_tower(cfg) -> None:
    """Refuse a program that cannot run this cell."""
    try:
        from twotower_tpu_torch.models import seq_tower  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"the program has no sequence user tower: {e}") from e
    if getattr(cfg.model, "user_tower", "mlp") != "sequence":
        raise RuntimeError("the program's configuration has no sequence user tower "
                           "(model.user_tower is not kept)")


def window_lengths(spec: dict, stream: int, streams: int, seed: int) -> np.ndarray:
    """Window lengths of ``streams`` streams of ``stream`` slots: Zipf with
    ``exponent`` over ``[min, max]``, each stream's last window cut so that
    the stream is full."""
    lo, hi = int(spec["min"]), int(spec["max"])
    values = np.arange(lo, hi + 1)
    p = values.astype(np.float64) ** -float(spec["exponent"])
    rng = np.random.default_rng(tr.seed_for(seed, LENGTHS))
    out = []
    for _ in range(streams):
        lens = rng.choice(values, size=stream // lo + 1, p=p / p.sum())
        n = int(np.searchsorted(np.cumsum(lens), stream))
        lens = lens[:n + 1].copy()
        lens[n] = stream - int(lens[:n].sum())
        out.append(lens)
    return np.concatenate(out)


def columns(run, num_items: int, num_users: int, device):
    """The epoch's streams (``hist_idx``, ``item_idx``, ``pos``, ``weight``)
    and log q of the drawn items."""
    t = run.cell.traffic
    stream, streams = int(t["stream"]), int(t["streams_per_epoch"])
    lens = torch.as_tensor(window_lengths(t["window"], stream, streams, run.seed), device=device)
    items = tr.draw_ids(t["items"], int(lens.sum() + len(lens)), num_items, run.seed, tr.ITEMS,
                        device, num_users=num_users)
    window = torch.repeat_interleave(torch.arange(len(lens), device=device), lens)
    slot_start = torch.cumsum(lens, 0) - lens
    pos = torch.arange(len(window), device=device) - slot_start[window]
    at = (torch.cumsum(lens + 1, 0) - (lens + 1))[window] + pos
    cols = {"hist_idx": items[at].int(), "item_idx": items[at + 1].int(), "pos": pos.int(),
            "weight": torch.ones(len(window), dtype=torch.float32, device=device)}
    return cols, tr.log_q(items, num_items), streams


def epoch_streams(seed: int, epoch: int, streams: int, device) -> torch.Tensor:
    """The epoch's order of streams, as the device loop draws it: a
    permutation from the generator seeded ``((seed + 1) << 32) + epoch``."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(((seed + 1) << 32) + epoch)
    return torch.randperm(streams, generator=gen, device=device)


def stream_batch(cols: dict, index: int, stream: int) -> dict:
    return {k: v[index * stream:(index + 1) * stream] for k, v in cols.items()}


def named_leaves(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """``(name, leaf)`` in the program's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in named_leaves(v, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.float()))


def _dense(params: dict) -> dict:
    return {k: params[k] for k in DENSE}


@dataclass
class TrainSeq:
    cfg: object
    device: torch.device
    prog: object
    state: object
    cols: dict
    log_q: torch.Tensor
    stream: int
    num_steps: int
    epoch: int = 0
    done: int = 0
    seen: dict = field(default_factory=dict)


def _loss_sum(prog) -> float:
    sums = getattr(prog, "_sums", None)
    if not sums or "loss" not in sums:
        raise RuntimeError("the epoch program keeps no loss sum to read a step's loss from")
    return float(sums["loss"])


def _next_step(obj: TrainSeq) -> bool:
    """One step; at the epoch's end, the epoch closed and the next begun
    first. Returns False where the closed epoch's metrics were not finite."""
    finite = True
    if obj.done == obj.num_steps:
        from twotower_tpu_torch.training.loop import _host_metrics

        obj.state, metrics = obj.prog.end_epoch()
        finite = all(math.isfinite(v) for v in _host_metrics(metrics).values())
        obj.epoch += 1
        obj.done = 0
        obj.prog.begin_epoch(obj.state, obj.cols, obj.epoch, obj.log_q)
    obj.prog.step()
    obj.done += 1
    return finite


def _rows_ids(batches: list[dict]) -> torch.Tensor:
    return torch.unique(torch.cat([torch.cat([b["hist_idx"], b["item_idx"]]).long()
                                   for b in batches]))


def setup(run) -> TrainSeq:
    from twotower_tpu_torch.training.device_loop import make_epoch_fn
    from twotower_tpu_torch.training.state import TrainState, make_optimizer

    cfg = program_config(run)
    _require_sequence_tower(cfg)
    from twotower_tpu_torch.models import seq_tower

    dev = torch.device(run.device)
    run.mark("program")
    c = run.cell.config
    model = c["port"]["model"]
    num_items = c["num_items"]
    params = ref.make_params(run.seed, model, num_items, dev)
    run.mark("weights")
    cols, log_q, steps = columns(run, num_items, c["num_users"], dev)
    stream = int(run.cell.traffic["stream"])
    if stream != cfg.training.batch_size:
        raise ValueError(f"the traffic's stream {stream} is not the configuration's batch "
                         f"{cfg.training.batch_size}")
    order0 = epoch_streams(run.program_seed, 0, steps, dev)
    batches = [stream_batch(cols, int(order0[i]), stream) for i in range(CHECKED_STEPS)]
    watched = stream_batch(cols, int(epoch_streams(run.program_seed, 1, steps, dev)[0]), stream)
    routes = []
    with torch.no_grad():
        b = batches[0]
        seq_tower.forward_stream(params, params["item_embedding"][b["hist_idx"].long()],
                                 b["pos"], b["weight"], cfg.model, routes=routes)
    _sync(dev)
    run.mark("columns")
    opt = make_optimizer(cfg.training)
    state = TrainState.for_config(params, opt, cfg)
    prog = make_epoch_fn(cfg, opt, steps, num_items=num_items, device=dev)
    prog.begin_epoch(state, cols, 0, log_q)
    _sync(dev)
    run.mark("state")
    obj = TrainSeq(cfg=cfg, device=dev, prog=prog, state=state, cols=cols, log_q=log_q,
                   stream=stream, num_steps=steps)
    e = cfg.model.embedding_dim
    first_ids = _rows_ids(batches[:1])
    ids3 = _rows_ids(batches)
    losses, total = [], 0.0
    for i in range(CHECKED_STEPS):
        _next_step(obj)
        now = _loss_sum(prog)
        losses.append(now - total)
        total = now
        if i == 0:  # the gradient as Adam got it: mu = (1 - b1) g after one update
            mu = state.opt_state.mu
            moments = state.table_state["item_embedding"]["moments"]
            grad1 = {n: _norm(t) / (1.0 - B1) for n, t in named_leaves(_dense(mu))}
            grad1["item_embedding"] = _norm(moments[first_ids, :e]) / (1.0 - B1)
    change3 = {}
    for path, t0 in ref.iter_weights(run.seed, model, num_items, dev):
        name = ".".join(map(str, path))
        now = _at(state.params, path)
        change3[name] = (_norm(now[ids3] - t0[ids3]) if name == "item_embedding"
                         else _norm(now - t0))
        del t0
    run.mark("steps")
    while obj.done < obj.num_steps:  # the rest of the epoch
        _next_step(obj)
    obj.seen.update(losses=losses, grad1=grad1, change3=change3, batches=batches, ids3=ids3,
                    first_ids=first_ids, routes=[r.cpu() for r in routes],
                    watched=_watch(obj, watched))
    run.mark("watched")
    _sync(dev)
    return obj


def _host_copy(tree):
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_host_copy(v) for v in tree]
    return tree.to("cpu", copy=True)


def _watch(obj: TrainSeq, batch: dict) -> dict:
    """The watched step (the first after the epoch's end): the state it
    starts from, kept in host memory, and what the program did in it, as
    norms."""
    e = obj.cfg.model.embedding_dim
    ids = _rows_ids([batch])
    st = obj.state
    table = st.params["item_embedding"]
    moments = st.table_state["item_embedding"]["moments"]
    before = {"dense": _host_copy(_dense(st.params)), "mu": _host_copy(_dense(st.opt_state.mu)),
              "nu": _host_copy(_dense(st.opt_state.nu)), "rows": table[ids].cpu(),
              "rows_mo": moments[ids].cpu()}
    steps_before = int(st.step) + obj.done
    ended = obj.done == obj.num_steps
    _next_step(obj)
    if not ended:
        raise RuntimeError("the watched step must follow an epoch's end")
    st = obj.state
    loss = _loss_sum(obj.prog)  # the sums restart at the epoch's start: this step's loss
    grads, change = {}, {}
    for (n, p), (_, mu_new), (_, p_old), (_, mu_old) in zip(
            named_leaves(_dense(st.params)), named_leaves(_dense(st.opt_state.mu)),
            named_leaves(before["dense"]), named_leaves(before["mu"])):
        mu_old = mu_old.to(obj.device)
        grads[n] = _norm(mu_new - B1 * mu_old) / (1.0 - B1)
        change[n] = _norm(p - p_old.to(obj.device))
    mo_new = st.table_state["item_embedding"]["moments"][ids]
    mo_old = before["rows_mo"].to(obj.device)
    grads["item_embedding"] = _norm(mo_new[:, :e] - B1 * mo_old[:, :e]) / (1.0 - B1)
    change["item_embedding"] = _norm(st.params["item_embedding"][ids]
                                     - before["rows"].to(obj.device))
    return {"batch": batch, "ids": ids, "before": before, "loss": loss, "grads": grads,
            "change": change, "step": steps_before + 1}


def _steps_for(obj: TrainSeq, seconds: float) -> tuple[int, int]:
    steps = bad = 0
    t0 = time.perf_counter()
    while True:
        bad += not _next_step(obj)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            return steps, bad


def window(obj: TrainSeq, seconds: float) -> dict:
    _sync(obj.device)
    t0 = time.perf_counter()
    steps, bad = _steps_for(obj, seconds)
    _sync(obj.device)
    elapsed = time.perf_counter() - t0
    return {"e2e": {"train_examples_per_s": steps * obj.stream / elapsed},
            "attempted": steps, "failed": bad, "layer": {"window_steps": steps}}


def trace(obj: TrainSeq, run) -> tuple[dict, object]:
    from twotower_tpu_torch.utils import profiling

    t = run.cell.traffic
    times = []
    for _ in range(int(t["replays_timed"])):
        if obj.done == obj.num_steps:
            _next_step(obj)  # an epoch boundary is not a replay
            continue
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        start.record()
        _next_step(obj)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    replay_ms = statistics.median(a.elapsed_time(b) for a, b in times)
    profiling.reset()  # the counters count the traced window's steps
    (steps, _), trace, reduce_s = traced(lambda: _steps_for(obj, float(t["trace_seconds"])))
    return {"replay_ms": replay_ms, "traced_steps": steps, "reduce_s": reduce_s}, trace


def release(obj: TrainSeq) -> dict:
    kept = {"seen": obj.seen, "log_q": obj.log_q, "cfg": obj.cfg, "stream": obj.stream}
    obj.prog = obj.state = obj.cols = None
    if obj.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return kept


# ---------------------------------------------------------------------------
# The check
# ---------------------------------------------------------------------------


def _ref_cfg(cfg) -> dict:
    import dataclasses

    m = cfg.model
    return dict(dataclasses.asdict(m.sequence), embedding_dim=m.embedding_dim,
                temperature=cfg.retrieval.temperature, l2=m.l2_regularization,
                dropout=m.dropout_rate)


def _dtype(cfg, control: bool) -> torch.dtype:
    """The reference's precision: float32; the control's the precision
    below the configuration's ``compute_dtype`` (float8 e4m3 below
    bfloat16)."""
    if not control:
        return torch.float32
    name = control_of(cfg.model.compute_dtype)
    return torch.float8_e4m3fn if name == "fp8" else getattr(torch, name)


def _masks(run, cfg, stream: int, steps_before: int, steps: int) -> list[list[torch.Tensor]]:
    """The item tower's dropout keep masks of ``steps`` steps after
    ``steps_before``, as the device loop's generator (seeded ``seed + 1``)
    draws them: each hidden layer's ``torch.rand`` in turn, step after
    step."""
    dev = torch.device(run.device)
    gen = torch.Generator(device=dev).manual_seed(run.program_seed + 1)
    widths = list(cfg.model.item_tower_dims[:-1])
    rate = cfg.model.dropout_rate
    out = []
    for i in range(steps_before + steps):
        masks = [torch.rand((stream, w), generator=gen, device=dev) < 1.0 - rate for w in widths]
        if i >= steps_before:
            out.append(masks)
    return out


def _zero_state(params: dict, rows: torch.Tensor) -> dict:
    """Adam's moments at the run's start, in the reference's layout."""
    leaves = ref.dense_leaves(params)
    return {"mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves],
            "rows_mu": torch.zeros_like(rows), "rows_nu": torch.zeros_like(rows)}


def first_steps(kept: dict, run, control: bool = False) -> dict:
    """The reference's first steps from the weights made again, as norms in
    the program's names, with the first step's routes."""
    seen, cfg = kept["seen"], kept["cfg"]
    c = run.cell.config
    dev = torch.device(run.device)
    params = ref.make_params(run.seed, c["port"]["model"], c["num_items"], dev)
    ids = seen["ids3"]
    params["item_embedding"] = (ids, params["item_embedding"][ids].clone())
    state = _zero_state(params, params["item_embedding"][1])
    masks = _masks(run, cfg, kept["stream"], 0, CHECKED_STEPS)
    rc, dtype = _ref_cfg(cfg), _dtype(cfg, control)
    block = int(run.cell.traffic["reference_block"])
    losses, grad1, routes = [], None, None
    for t, batch in enumerate(seen["batches"], start=1):
        loss, g_dense, g_rows, r = ref.step(params, state, batch, kept["log_q"], rc, masks[t - 1],
                                            t, cfg.training.learning_rate, dtype, block)
        losses.append(loss)
        if t == 1:
            names = [n for n, _ in named_leaves(_dense(params))]
            grad1 = {n: _norm(g) for n, g in zip(names, g_dense)}
            at = torch.searchsorted(ids, seen["first_ids"])
            grad1["item_embedding"] = _norm(g_rows[at])
            routes = [x.cpu() for x in r]
        del g_dense, g_rows
    change = {}
    for path, t0 in ref.iter_weights(run.seed, c["port"]["model"], c["num_items"], dev):
        name = ".".join(map(str, path))
        now = params["item_embedding"][1] if name == "item_embedding" else _at(params, path)
        change[name] = _norm(now - (t0[ids] if name == "item_embedding" else t0))
        del t0
    return {"losses": losses, "grad1": grad1, "change3": change, "routes": routes}


def watched_step(kept: dict, run, control: bool = False) -> dict:
    """The reference's watched step from the program's state before it."""
    w, cfg = kept["seen"]["watched"], kept["cfg"]
    dev = torch.device(run.device)
    e = cfg.model.embedding_dim

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_dev(v) for v in tree]
        return tree.to(dev, copy=True)

    b = w["before"]
    params = to_dev(b["dense"])
    before_rows = b["rows"].to(dev)
    params["item_embedding"] = (w["ids"], before_rows.clone())
    mo = b["rows_mo"].to(dev)
    state = {"mu": ref.dense_leaves(to_dev(b["mu"])), "nu": ref.dense_leaves(to_dev(b["nu"])),
             "rows_mu": mo[:, :e].clone(), "rows_nu": mo[:, e:].clone()}
    masks = _masks(run, cfg, kept["stream"], w["step"] - 1, 1)[0]
    loss, g_dense, g_rows, _ = ref.step(params, state, w["batch"], kept["log_q"], _ref_cfg(cfg),
                                        masks, w["step"], cfg.training.learning_rate,
                                        _dtype(cfg, control),
                                        int(run.cell.traffic["reference_block"]))
    names = [n for n, _ in named_leaves(_dense(params))]
    grads = {n: _norm(g) for n, g in zip(names, g_dense)}
    grads["item_embedding"] = _norm(g_rows)
    change = {n: _norm(p - p0.to(dev)) for (n, p), (_, p0) in zip(
        named_leaves(_dense(params)), named_leaves(b["dense"]))}
    change["item_embedding"] = _norm(params["item_embedding"][1] - before_rows)
    return {"loss": loss, "grads": grads, "change": change}


def _gaps(seen: dict, refd: dict, median: float) -> tuple[float, str]:
    return max((abs(seen[n] - r) / max(r, median), n) for n, r in refd.items())


def compare(grad_p: dict, grad_r: dict, change_p: dict, change_r: dict) -> tuple:
    """The worst leaf's gap of the gradient's norm (against the reference's
    norm of the leaf or the median leaf's), and of the change's norm,
    leaves whose reference gradient is under a thousandth of the median
    leaf's left out of the change (they move by round-off alone)."""
    median = statistics.median(grad_r.values())
    grad_gap = _gaps(grad_p, grad_r, median)
    kept = {n: v for n, v in change_r.items() if grad_r[n] >= 1e-3 * median}
    change_gap = _gaps(change_p, kept, statistics.median(kept.values()))
    return grad_gap, change_gap, len(change_r) - len(kept)


def flip_share(program: list, reference: list) -> float:
    """The share of (slot, MoE layer) pairs whose expert sets differ."""
    differ = total = 0
    for p, r in zip(program, reference):
        a, b = torch.sort(p.long(), dim=1).values, torch.sort(r.long(), dim=1).values
        differ += int((a != b).any(dim=1).sum())
        total += a.shape[0]
    return differ / max(total, 1)


def numbers(program: dict, watched_p: dict, first: dict, watched_r: dict) -> tuple[dict, tuple]:
    losses = [abs(p - r) / abs(r) for p, r in zip(program["losses"], first["losses"])]
    (g, gl), (ch, cl), out1 = compare(program["grad1"], first["grad1"], program["change3"],
                                      first["change3"])
    (wg, wgl), (wc, wcl), out2 = compare(watched_p["grads"], watched_r["grads"],
                                         watched_p["change"], watched_r["change"])
    return ({"loss_gap": max(losses), "grad1_gap": g, "change3_gap": ch,
             "window_loss_gap": abs(watched_p["loss"] - watched_r["loss"]) / abs(watched_r["loss"]),
             "window_grad_gap": wg, "window_change_gap": wc,
             "route_flip_share": flip_share(program["routes"], first["routes"])},
            (out1 + out2, (gl, cl), (wgl, wcl)))


def check(kept: dict, run) -> dict[str, float]:
    seen = kept["seen"]
    first = first_steps(kept, run)
    watched = watched_step(kept, run)
    out, (left_out, worst, worst_w) = numbers(seen, seen["watched"], first, watched)
    print(f"leaves left out of the change: {left_out}; worst leaves (gradient, change): first "
          f"steps {worst}, watched step {worst_w}; route flips {out['route_flip_share']:.6f}",
          file=sys.stderr)
    return out


def control(kept: dict, run) -> dict[str, float]:
    """The control's readings: the reference at the precision below the
    configuration's ``compute_dtype`` put in the program's place, against
    the reference, over the first steps and the watched step."""
    first, low = first_steps(kept, run), first_steps(kept, run, control=True)
    watched, low_w = watched_step(kept, run), watched_step(kept, run, control=True)
    out, _ = numbers(low, low_w, first, watched)
    return out

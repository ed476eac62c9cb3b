"""Training through the device loop: ``training/device_loop.py::
make_epoch_fn``'s program (``begin_epoch``, ``step``, ``end_epoch``), the path
``DeviceTrainer.fit`` runs an epoch on, without validation or saves.

Set-up makes the weights and a whole epoch of columns on the device from the
seed, builds the train state and the epoch program, and runs the epoch's
first three steps through ``step()``: on a card the two warm-up steps and
the capture of the CUDA graph. It reads what the check needs after each:
the loss, the first step's gradients from the Adam state, the weights after
the third. The window continues the epoch with graph replays, epochs back
to back, the epoch's metrics read once at each end as ``DeviceTrainer``
reads them. Around the first step of epoch ``WATCHED_EPOCH``, a replay the
window runs after an epoch end, it keeps the rows and tower leaves that
step reads and writes, with their Adam moments, before and after (a few
small copies on the device, no wait); where the window closes before that
step, the check runs on to it.

The check follows the reference from the weights made again from the seed
through the first three steps, and from the program's state before the
watched step through that step (the rows, leaves and moments kept; the
step's order, dropout masks and step count the reference derives itself).

Traffic keys: ``rows_per_epoch``, ``users`` and ``items`` (id
distributions, ``harness/traffic.py``), ``weights`` (``harness/weights.py``),
``trace_seconds``, ``replays_timed`` and ``check`` (the limits).
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

from perfbench.harness import traffic as tr
from perfbench.harness import weights as wt
from perfbench.harness.program import control_of, model_of, program_config
from perfbench.harness.trace import traced
from perfbench.reference import train_ref

CHECKED_STEPS = 3
WATCHED_EPOCH = 1
TABLES = ("user_embedding", "item_embedding")
TOWERS = ("user_tower", "item_tower")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


@dataclass
class Train:
    cfg: object
    device: torch.device
    prog: object
    state: object
    columns: dict
    log_q: torch.Tensor
    batch: int
    num_steps: int
    epoch: int = 0
    done: int = 0
    seen: dict = field(default_factory=dict)  # what the check reads
    watch: dict | None = None  # the watched step's rows, until it has run


def _columns(run, num_users, num_items, batch, device):
    t = run.cell.traffic
    rows = int(t["rows_per_epoch"])
    users = tr.draw_ids(t["users"], rows, num_users, run.seed, tr.USERS, device)
    items = tr.draw_ids(t["items"], rows, num_items, run.seed, tr.ITEMS, device,
                        num_users=num_users)
    log_q = tr.log_q(items, num_items)
    steps = -(-rows // batch)
    pad = steps * batch - rows
    zeros = torch.zeros(pad, dtype=torch.long, device=device)
    weight = torch.ones(steps * batch, dtype=torch.float32, device=device)
    weight[rows:] = 0.0
    columns = {"user_idx": torch.cat([users, zeros]).int(),
               "item_idx": torch.cat([items, zeros]).int(), "weight": weight}
    return columns, log_q, steps


def _first_batches(run, columns, steps_total: int, batch: int, device, epoch: int,
                   count: int) -> list[dict]:
    """The rows of ``epoch``'s first ``count`` steps, by the reference's
    derivation of the epoch's order."""
    order = train_ref.epoch_order(run.program_seed, epoch, steps_total * batch, device)
    return [{k: v[order[i * batch:(i + 1) * batch]] for k, v in columns.items()}
            for i in range(count)]


def _unique_ids(batch: dict) -> dict:
    return {name: torch.unique(batch[key].long())
            for name, key in (("user_embedding", "user_idx"), ("item_embedding", "item_idx"))}


def _snapshot(state, ids: dict) -> dict:
    """Copies, on the device, of the tower leaves and the rows ``ids``
    with their Adam moments."""
    mu, nu = state.opt_state.mu, state.opt_state.nu
    return {
        "towers": {k: [{n: t.clone() for n, t in layer.items()} for layer in state.params[k]]
                   for k in TOWERS},
        "tower_mo": {k: [{n: (mu[k][i][n].clone(), nu[k][i][n].clone()) for n in layer}
                         for i, layer in enumerate(state.params[k])] for k in TOWERS},
        "tables": {k: state.params[k][ids[k]].clone() for k in TABLES},
        "table_mo": {k: state.table_state[k]["moments"][ids[k]].clone() for k in TABLES},
    }


def _loss_tensor(prog) -> torch.Tensor:
    sums = getattr(prog, "_sums", None)
    if not sums or "loss" not in sums:
        raise RuntimeError("the epoch program keeps no loss sum to read a step's loss from")
    return sums["loss"]


def _loss_sum(prog) -> float:
    return float(_loss_tensor(prog))


def setup(run) -> Train:
    from twotower_tpu_torch.training.device_loop import make_epoch_fn
    from twotower_tpu_torch.training.state import TrainState, make_optimizer

    cfg = program_config(run)
    dev = torch.device(run.device)
    run.mark("program")
    c = run.cell.config
    num_users, num_items, batch = c["num_users"], c["num_items"], cfg.training.batch_size
    params = wt.make_params(run.cell.traffic["weights"], run.seed, num_users, num_items,
                            model_of(cfg), dev)
    run.mark("weights")
    columns, log_q, steps = _columns(run, num_users, num_items, batch, dev)
    watched = _first_batches(run, columns, steps, batch, dev, WATCHED_EPOCH, 1)[0]
    _sync(dev)
    run.mark("columns")
    opt = make_optimizer(cfg.training)
    state = TrainState.for_config(params, opt, cfg)
    prog = make_epoch_fn(cfg, opt, steps, num_items=num_items, device=dev)
    prog.begin_epoch(state, columns, 0, log_q)
    _sync(dev)
    run.mark("state")
    obj = Train(cfg=cfg, device=dev, prog=prog, state=state, columns=columns, log_q=log_q,
                batch=batch, num_steps=steps,
                watch={"batch": watched, "ids": _unique_ids(watched)})
    e = cfg.model.embedding_dim
    b1 = train_ref.B1
    batches = _first_batches(run, columns, steps, batch, dev, 0, CHECKED_STEPS)
    ids = {name: torch.unique(torch.cat([b[key].long() for b in batches]))
           for name, key in (("user_embedding", "user_idx"), ("item_embedding", "item_idx"))}
    first_ids = _unique_ids(batches[0])
    losses, total = [], 0.0
    for i in range(CHECKED_STEPS):
        prog.step()
        obj.done += 1
        now = _loss_sum(prog)
        losses.append(now - total)
        total = now
        if i == 0:  # the gradient as Adam got it: mu = (1 - b1) g after one update
            mu = state.opt_state.mu
            obj.seen["grad1"] = {
                "towers": {k: [{n: t / (1.0 - b1) for n, t in layer.items()} for layer in mu[k]]
                           for k in TOWERS},
                "tables": {k: state.table_state[k]["moments"][first_ids[k], :e] / (1.0 - b1)
                           for k in TABLES},
            }
    run.mark("steps")
    obj.seen.update(
        losses=losses, batches=batches, ids=ids, first_ids=first_ids,
        towers={k: [{n: t.clone() for n, t in layer.items()} for layer in state.params[k]]
                for k in TOWERS},
        tables={k: state.params[k][ids[k]].clone() for k in TABLES},
    )
    _sync(dev)
    return obj


def _next_step(obj: Train) -> bool:
    """One step; at the epoch's end, the epoch closed and the next begun
    first. Returns False where the closed epoch's metrics were not finite."""
    finite = True
    if obj.done == obj.num_steps:
        from twotower_tpu_torch.training.loop import _host_metrics

        obj.state, metrics = obj.prog.end_epoch()
        finite = all(math.isfinite(v) for v in _host_metrics(metrics).values())
        obj.epoch += 1
        obj.done = 0
        obj.prog.begin_epoch(obj.state, obj.columns, obj.epoch, obj.log_q)
    watched = obj.watch is not None and obj.epoch == WATCHED_EPOCH and obj.done == 0
    if watched:
        before = _snapshot(obj.state, obj.watch["ids"])
    obj.prog.step()
    obj.done += 1
    if watched:
        obj.seen["watched"] = {"batch": obj.watch["batch"], "ids": obj.watch["ids"],
                               "before": before, "after": _snapshot(obj.state, obj.watch["ids"]),
                               "loss": _loss_tensor(obj.prog).clone()}
        obj.watch = None
    return finite


def _steps_for(obj: Train, seconds: float) -> tuple[int, int]:
    steps = bad = 0
    t0 = time.perf_counter()
    while True:
        bad += not _next_step(obj)
        steps += 1
        if time.perf_counter() - t0 >= seconds:
            return steps, bad


def window(obj: Train, seconds: float) -> dict:
    _sync(obj.device)
    t0 = time.perf_counter()
    steps, bad = _steps_for(obj, seconds)
    _sync(obj.device)
    elapsed = time.perf_counter() - t0
    return {"e2e": {"train_examples_per_s": steps * obj.batch / elapsed},
            "attempted": steps, "failed": bad, "layer": {"window_steps": steps}}


def trace(obj: Train, run) -> tuple[dict, object]:
    t = run.cell.traffic
    times = []
    for _ in range(int(t["replays_timed"])):
        start, end = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        if obj.done == obj.num_steps:
            _next_step(obj)  # an epoch boundary is not a replay
            continue
        start.record()
        _next_step(obj)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    replay_ms = statistics.median(a.elapsed_time(b) for a, b in times)
    (steps, _), trace, reduce_s = traced(lambda: _steps_for(obj, float(t["trace_seconds"])))
    return {"replay_ms": replay_ms, "traced_steps": steps, "reduce_s": reduce_s}, trace


def release(obj: Train) -> dict:
    while obj.watch is not None:  # the window closed before the watched step: run on to it
        _next_step(obj)
    kept = {"seen": obj.seen, "log_q": obj.log_q, "cfg": obj.cfg, "num_steps": obj.num_steps,
            "batch": obj.batch}
    obj.prog = obj.state = obj.columns = None
    if obj.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return kept


def _gap(program: torch.Tensor, reference: torch.Tensor, floor: float) -> float:
    p, r = float(torch.linalg.vector_norm(program)), float(torch.linalg.vector_norm(reference))
    return abs(p - r) / max(r, floor)


def _worst(pairs: dict[str, tuple]) -> tuple[float, str]:
    """Worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or the median leaf's, and
    the leaf's name."""
    norms = [float(torch.linalg.vector_norm(r)) for _, r in pairs.values()]
    median = statistics.median(norms)
    return max((_gap(p, r, median), name) for name, (p, r) in pairs.items())


def _dtype(cfg, control: bool) -> torch.dtype:
    """The towers' dtype: the configuration's ``compute_dtype``, or for the
    control the precision below it (float8 e4m3 below bfloat16)."""
    name = cfg.model.compute_dtype
    name = control_of(name) if control else name
    return torch.float8_e4m3fn if name == "fp8" else getattr(torch, name)


def _follow(kept: dict, run, towers, rows, batches, control: bool, **start) -> dict:
    cfg = kept["cfg"]
    steps_before = start.get("steps_before", 0)
    gen = train_ref.dropout_generator(run.program_seed, steps_before, kept["batch"], towers,
                                      torch.device(run.device))
    return train_ref.follow_steps(
        towers, rows, batches, kept["log_q"], lr=cfg.training.learning_rate,
        l2=cfg.model.l2_regularization, temperature=cfg.retrieval.temperature,
        dropout=cfg.model.dropout_rate, dtype=_dtype(cfg, control), dropout_gen=gen, **start)


def reference(kept: dict, run, control: bool = False) -> dict:
    """The reference's first steps from the weights made again from the
    seed (``control``: the towers at the precision below the
    configuration's)."""
    seen = kept["seen"]
    params = initial_weights(kept, run)
    return _follow(kept, run, params["towers"],
                   {k: (seen["ids"][k], params["tables"][k]) for k in TABLES},
                   seen["batches"], control)


def watched_reference(kept: dict, run, control: bool = False) -> dict:
    """The reference's watched step from the program's state before it (the
    rows and leaves kept, with their moments), as the run's step
    ``WATCHED_EPOCH * num_steps + 1``."""
    w = kept["seen"]["watched"]
    e = kept["cfg"].model.embedding_dim
    before = w["before"]
    moments = {"towers": before["tower_mo"],
               "tables": {k: (mo[:, :e], mo[:, e:]) for k, mo in before["table_mo"].items()}}
    return _follow(kept, run, before["towers"],
                   {k: (w["ids"][k], before["tables"][k]) for k in TABLES}, [w["batch"]],
                   control, moments=moments, steps_before=WATCHED_EPOCH * kept["num_steps"])


def watched_seen(kept: dict) -> tuple[dict, dict]:
    """What the program did in the watched step, in ``compare``'s layout:
    its loss, its gradient as Adam got it (``(mu' - b1 mu) / (1 - b1)``)
    and the weights after; and the weights before."""
    w = kept["seen"]["watched"]
    e = kept["cfg"].model.embedding_dim
    b1 = train_ref.B1
    before, after = w["before"], w["after"]
    grads = {k: [{n: (after["tower_mo"][k][i][n][0] - b1 * mu) / (1.0 - b1)
                  for n, (mu, _) in layer.items()} for i, layer in enumerate(before["tower_mo"][k])]
             for k in TOWERS}
    tables = {k: (after["table_mo"][k][:, :e] - b1 * before["table_mo"][k][:, :e]) / (1.0 - b1)
              for k in TABLES}
    seen = {"losses": [float(w["loss"])], "grad1": {"towers": grads, "tables": tables},
            "towers": after["towers"], "tables": after["tables"], "ids": w["ids"],
            "first_ids": w["ids"]}
    return seen, {"towers": before["towers"], "tables": before["tables"]}


def compare(seen: dict, ref: dict, initial: dict) -> dict:
    """The numbers the check compares: the worst step's loss gap, the worst
    leaf's gap of the first gradient's norm, and of the weights' change over
    the steps, leaves whose reference gradient is under a thousandth of the
    median leaf's left out (they move by round-off alone)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(seen["losses"], ref["losses"])]
    ref_towers = dict(zip(_names(ref["towers"]), ref["grad1"]["towers"]))
    grad = {n: (t, ref_towers[n]) for n, t in zip(_names(seen["grad1"]["towers"]),
                                                   _leaves(seen["grad1"]["towers"]))}
    for k in TABLES:  # the reference's table gradient over the first step's rows
        slots = torch.searchsorted(seen["ids"][k], seen["first_ids"][k])
        grad[k] = (seen["grad1"]["tables"][k], ref["grad1"]["tables"][k][slots])
    norms = {n: float(torch.linalg.vector_norm(r)) for n, (_, r) in grad.items()}
    floor = 1e-3 * statistics.median(norms.values())
    change = {}
    init_towers = dict(zip(_names(initial["towers"]), _leaves(initial["towers"])))
    for n, p, r in zip(_names(seen["towers"]), _leaves(seen["towers"]), _leaves(ref["towers"])):
        if norms[n] >= floor:
            change[n] = (p - init_towers[n], r - init_towers[n])
    for k in TABLES:
        if norms[k] >= floor:
            change[k] = (seen["tables"][k] - initial["tables"][k],
                         ref["tables"][k] - initial["tables"][k])
    (grad_gap, grad_leaf), (change_gap, change_leaf) = _worst(grad), _worst(change)
    return {"loss_gap": max(losses), "grad1_gap": grad_gap, "change3_gap": change_gap,
            "leaves_left_out": len(grad) - len(change), "worst": (grad_leaf, change_leaf)}


def _names(towers: dict) -> list[str]:
    return [f"{k}.{i}.{n}" for k, v in towers.items() for i, layer in enumerate(v) for n in layer]


def _leaves(towers: dict) -> list[torch.Tensor]:
    return [t for v in towers.values() for layer in v for t in layer.values()]


def initial_weights(kept: dict, run) -> dict:
    """The weights made again from the seed: the towers and the rows of
    the first steps."""
    cfg, seen = kept["cfg"], kept["seen"]
    c = run.cell.config
    params = wt.make_params(run.cell.traffic["weights"], run.seed, c["num_users"],
                            c["num_items"], model_of(cfg), torch.device(run.device))
    return {"towers": {k: params[k] for k in TOWERS},
            "tables": {k: params[k][seen["ids"][k]] for k in TABLES}}


WATCHED = {"loss_gap": "window_loss_gap", "grad1_gap": "window_grad_gap",
           "change3_gap": "window_change_gap"}


def _numbers(kept: dict, run, seen: dict, ref: dict, seen_w: dict, ref_w: dict) -> dict:
    initial = initial_weights(kept, run)
    numbers = compare(seen, ref, initial)
    watched = compare(seen_w, ref_w, watched_seen(kept)[1])
    left_out = numbers.pop("leaves_left_out") + watched.pop("leaves_left_out")
    worst = (numbers.pop("worst"), watched.pop("worst"))
    numbers.update({WATCHED[k]: v for k, v in watched.items()})
    return numbers, (left_out, worst)


def check(kept: dict, run) -> dict[str, float]:
    seen_w, _ = watched_seen(kept)
    numbers, (left_out, worst) = _numbers(kept, run, kept["seen"], reference(kept, run), seen_w,
                                          watched_reference(kept, run))
    print(f"leaves left out of the change: {left_out}; worst leaves (gradient, change): first "
          f"steps {worst[0]}, watched step {worst[1]}", file=sys.stderr)
    return numbers


def _as_seen(low: dict, ref: dict, ids: dict, first_ids: dict) -> dict:
    """The control's steps in ``compare``'s layout of what the program did."""
    slots = {k: torch.searchsorted(ids[k], first_ids[k]) for k in TABLES}
    return {"losses": low["losses"],
            "grad1": {"towers": _as_tree(ref["towers"], low["grad1"]["towers"]),
                      "tables": {k: low["grad1"]["tables"][k][slots[k]] for k in TABLES}},
            "towers": low["towers"], "tables": low["tables"], "ids": ids, "first_ids": first_ids}


def control(kept: dict, run) -> dict[str, float]:
    """The control's readings: the reference at the precision below the
    configuration's ``compute_dtype`` (``harness/program.py``) put in the
    program's place, against the reference, over the first steps and the
    watched step."""
    seen = kept["seen"]
    ref, low = reference(kept, run), reference(kept, run, control=True)
    ids = seen["watched"]["ids"]
    ref_w, low_w = watched_reference(kept, run), watched_reference(kept, run, control=True)
    numbers, _ = _numbers(kept, run, _as_seen(low, ref, seen["ids"], seen["first_ids"]),
                          ref, _as_seen(low_w, ref_w, ids, ids), ref_w)
    return numbers


def _as_tree(like: dict, flat: list) -> dict:
    it = iter(flat)
    return {k: [{n: next(it) for n in layer} for layer in v] for k, v in like.items()}

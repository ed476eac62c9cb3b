"""Rank bodies of the port's mesh tests (run by ``torch_mesh_ranks.run_ranks``
on ``gloo`` ranks on the CPU). This module imports no JAX: each rank starts
with torch and the port only. Every body takes a ``spec`` dict of numpy
arrays and plain values built by the test, and returns what the test
compares."""

from __future__ import annotations

import numpy as np
import torch


def _config(overrides: dict):
    from twotower_tpu_torch.config import Config

    return Config().with_overrides(overrides)


def _mesh(cfg, **kw):
    from twotower_tpu_torch.parallel import build_mesh

    return build_mesh(cfg.mesh, device="cpu", **kw)


def _t(x, dtype=None):
    return None if x is None else torch.as_tensor(np.asarray(x), dtype=dtype)


def train_steps(rank, world, workdir, spec):
    """``spec["steps"]`` mesh steps from the bridged ``spec["state"]`` over
    ``spec["batches"]`` (global batches: each rank takes its data rows),
    with ``spec["neg_ids"][i]`` handed in where given. Returns the metrics
    of every step and the gathered final state."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.parallel.sharding import data_rows
    from twotower_tpu_torch.training.loop import make_raw_step
    from twotower_tpu_torch.training.state import make_optimizer

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    opt = make_optimizer(cfg.training)
    state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
    step = make_raw_step(cfg, opt, num_items=spec.get("num_items"), mesh=mesh,
                         state_template=state)
    lq = _t(spec.get("log_q"), torch.float32)
    tok = _t(spec.get("item_tokens"))
    gen = torch.Generator().manual_seed(1)
    metrics = []
    for i, b in enumerate(spec["batches"]):
        local = {k: data_rows(mesh, torch.as_tensor(v)) for k, v in b.items()}
        negs = spec.get("neg_ids")
        state, m = step(state, local, gen, lq, tok,
                        neg_ids=None if negs is None else torch.as_tensor(negs[i]))
        metrics.append({k: float(v) for k, v in m.items()})
    final = bridge.gathered_state_to_numpy(state)
    return {"metrics": metrics, "state": final if rank == 0 else None}


def lookups(rank, world, workdir, spec):
    """``alltoall_lookup`` and ``psum_lookup`` over a ``world``-rank axis on
    one table: the rows and the table gradient of ``sum(rows * rows *
    spec["scale"])`` for each rank's own ids (``spec["ids"][rank]``), the
    replicated lookup's rows and gradient on the shared ids, and the drop
    count at ``spec["capacity"]``; ``alltoall_row_update`` from the same
    ids and gradients."""
    from twotower_tpu_torch.parallel import a2a

    cfg = _config({"mesh.num_model": world})
    mesh = _mesh(cfg)
    ax = mesh.model
    table = torch.as_tensor(spec["table"])
    rps = table.shape[0] // world
    out = {}
    for name, fn in (("alltoall", a2a.alltoall_lookup), ("psum", a2a.psum_lookup)):
        shard = table[rank * rps:(rank + 1) * rps].clone().requires_grad_()
        ids = torch.as_tensor(spec["ids"][rank] if name == "alltoall" else spec["shared"])
        rows = fn(shard, ids, ax)
        (torch.sum(rows * rows * torch.as_tensor(spec["scale"][:len(ids)])[:, None])).backward()
        out[name] = {"rows": rows, "grad": ax.all_gather(shard.grad)}
        shard = table[rank * rps:(rank + 1) * rps].clone().requires_grad_()
        rep = a2a.sharded_embedding_lookup(shard, torch.as_tensor(spec["shared"]), ax,
                                           strategy=name)
        torch.sum(rep * rep).backward()
        out[f"{name}_replicated"] = {"rows": rep, "grad": ax.all_gather(shard.grad)}
    shard = table[rank * rps:(rank + 1) * rps].clone()
    rows, dropped = a2a.alltoall_lookup(shard, torch.as_tensor(spec["tight_ids"]), ax,
                                        capacity=spec["capacity"], return_stats=True)
    out["tight"] = {"rows": rows, "dropped": int(dropped)}
    for name, cap in (("update", None), ("update_tight", spec["update_capacity"])):
        shard = table[rank * rps:(rank + 1) * rps].clone()
        moments = torch.as_tensor(spec["moments"])[rank * rps:(rank + 1) * rps].clone()
        nsq, dropped = a2a.alltoall_row_update(
            shard, moments, torch.as_tensor(spec["ids"][rank]),
            torch.as_tensor(spec["row_grads"][rank]), ax, capacity=cap, lr=1e-3, step=3)
        out[name] = {"table": ax.all_gather(shard), "moments": ax.all_gather(moments),
                     "norm_sq": float(ax.all_reduce(nsq)),
                     "dropped": int(ax.all_reduce(dropped))}
    return out


def mesh_loss(rank, world, workdir, spec):
    """``make_mesh_loss`` over a ``world``-rank data axis: each rank's
    per-example values and the gradients of the global loss w.r.t. its
    rows of the user and item embeddings."""
    from twotower_tpu_torch.parallel.spmd import make_mesh_loss

    cfg = _config({"mesh.num_model": 1})
    mesh = _mesh(cfg)
    b = spec["user_emb"].shape[0] // world
    sl = slice(rank * b, (rank + 1) * b)
    u = torch.as_tensor(spec["user_emb"][sl]).requires_grad_()
    v = torch.as_tensor(spec["item_emb"][sl]).requires_grad_()
    w = torch.as_tensor(spec["weights"][sl])
    loss = make_mesh_loss(mesh, cfg)  # the plain block on the CPU
    per_ex, correct, raw = loss(u, v, torch.as_tensor(spec["item_idx"][sl]),
                                temperature=spec["temperature"],
                                log_q=_t(spec.get("log_q"), torch.float32), weights=w)
    denom = torch.clamp(mesh.data.all_reduce(w.sum()), min=1.0)
    share = torch.sum(per_ex * w) / denom
    share.backward()
    total = mesh.data.all_reduce(share.detach())
    return {"loss": float(total), "per_example": mesh.data.all_gather(per_ex.detach()),
            "correct": mesh.data.all_gather(correct), "du": mesh.data.all_gather(u.grad),
            "dv": mesh.data.all_gather(v.grad),
            "accuracy": float(mesh.data.all_reduce(torch.sum(correct * w)) / denom)}


def evaluate(rank, world, workdir, spec):
    """``Evaluator(mesh=)`` on the bridged params (sharded as the config's
    mesh layout), and the sharded searches on ``spec["corpus"]``."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.ops.topk import topk_mips_approx_sharded, topk_mips_sharded
    from twotower_tpu_torch.parallel.spmd import corpus_shard_rows

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
    ev = Evaluator(cfg, spec["num_items"], batch_size=spec["batch_size"], mesh=mesh,
                   item_tokens=spec.get("item_tokens"))
    metrics = ev.evaluate(state.params, spec["users"], spec["items"])
    out = {"metrics": metrics}
    corpus, query, k = (torch.as_tensor(spec[n]) for n in ("corpus", "query", "k"))
    n = corpus.shape[0]
    for name, exact, fn in (("exact", True, topk_mips_sharded),
                            ("approx", False, topk_mips_approx_sharded)):
        rows = corpus_shard_rows(n, mesh.num_model, exact)
        shard = torch.zeros(rows, corpus.shape[1])
        lo = mesh.m_idx * rows
        part = corpus[lo:lo + rows]
        shard[:len(part)] = part
        vals, ids = fn(query, shard, int(k), axis=mesh.model, num_items=n)
        out[name] = {"vals": vals, "ids": ids}
    return out


def epoch(rank, world, workdir, spec):
    """One device-loop epoch on the mesh (``make_epoch_fn(mesh=)``, eager on
    the CPU) over the handed-in permutation: epoch metrics and the gathered
    state."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn
    from twotower_tpu_torch.training.state import make_optimizer

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
    ds = DeviceDataset(spec["users"], spec["items"], cfg.training.batch_size, device="cpu")
    fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps,
                       num_items=spec["num_items"], device="cpu", mesh=mesh)
    state, m = fn(state, ds.columns, 0, _t(spec.get("log_q"), torch.float32),
                  perm=spec["perm"])
    return {"metrics": {k: float(v) for k, v in m.items()},
            "state": bridge.gathered_state_to_numpy(state)}


def trainer_fit(rank, world, workdir, spec):
    """``Trainer(mesh=)`` (or ``DeviceTrainer(mesh=)``) over a seeded
    synthetic split with validation, early stopping and checkpoints in
    ``workdir/ckpt``; ``spec["resume"]`` restores the latest checkpoint and
    trains on. Returns the history, the best metric and step, the saved
    steps and the gathered final params."""
    from pathlib import Path

    from twotower_tpu_torch.data import BatchPipeline, Preprocessor, generate_interactions
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.parallel.sharding import gather_params, process_row_spans
    from twotower_tpu_torch.training import Trainer
    from twotower_tpu_torch.training.device_loop import DeviceDataset, DeviceTrainer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.training.train import _EncodedColumns

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    if "train" in spec:  # the test's split, as encoded columns
        train = _EncodedColumns(*spec["train"])
        val_u, val_i = spec["val"]
        num_users, num_items, log_q = spec["num_users"], spec["num_items"], spec["log_q"]
    else:
        data = generate_interactions(num_users=200, num_items=100, num_interactions=3000,
                                     noise=0.2, device="cpu")
        pp = Preprocessor(cfg.preprocessing)
        splits = pp.split_data(pp.process(data))
        train, (val_u, val_i) = splits.train, (splits.val.user_idx, splits.val.item_idx)
        num_users, num_items = len(pp.vocab.users), len(pp.vocab.items)
        log_q = np.log(pp.vocab.items.frequencies + 1e-12)
    ev = Evaluator(cfg, num_items, batch_size=spec.get("eval_batch", 64), mesh=mesh)
    mgr = CheckpointManager(Path(spec["ckpt_dir"]), keep=3)
    common = dict(log_q=log_q, mesh=mesh, num_items=num_items,
                  evaluate_fn=ev.make_evaluate_fn(val_u, val_i), checkpoint_manager=mgr)
    if spec.get("device_loop"):
        trainer = DeviceTrainer(cfg, **common)
        train_input = DeviceDataset.from_interactions(train, cfg.training.batch_size,
                                                      device="cpu")
    else:
        trainer = Trainer(cfg, **common)
        train_input = BatchPipeline(train, cfg.training.batch_size, seed=cfg.training.seed,
                                    host_spans=process_row_spans(mesh, cfg.training.batch_size))
    state = trainer.init_state(num_users, num_items)
    if "state" in spec:
        state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
    start_epoch, restored = 0, -1
    if spec.get("resume"):
        state, meta = mgr.restore(state)
        start_epoch, restored = int(meta.get("epoch", 0)), int(state.step)
    res = trainer.fit(state, train_input, start_epoch=start_epoch)
    params = gather_params(res.state.params, res.state.sharding)
    return {
        "history": [{k: v for k, v in r.items() if k == "loss" or k.startswith("val/")}
                    for r in res.history],
        "best_metric": res.best_metric, "best_step": res.best_step,
        "ckpt_steps": np.asarray(mgr.all_steps()), "restored_step": restored,
        "state": bridge.gathered_state_to_numpy(res.state) if spec.get("state_out") else None,
        "params": params if rank == 0 else None,
    }


def checkpoint(rank, world, workdir, spec):
    """``spec["mode"] == "save"``: two mesh steps from the bridged state, then
    a collective save to ``spec["ckpt_dir"]``; ``"restore"``: restore the
    latest checkpoint into a fresh state of this mesh's layout. Returns the
    gathered state."""
    from pathlib import Path

    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.parallel.sharding import data_rows
    from twotower_tpu_torch.training.loop import make_raw_step
    from twotower_tpu_torch.training.state import init_train_state, make_optimizer
    from twotower_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    opt = make_optimizer(cfg.training)
    mgr = CheckpointManager(Path(spec["ckpt_dir"]), async_save=True)
    assert world == 1 or not mgr.async_save  # collective saves are synchronous
    if spec["mode"] == "save":
        state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
        step = make_raw_step(cfg, opt, mesh=mesh, state_template=state)
        for b in spec["batches"]:
            state, _ = step(state, {k: data_rows(mesh, torch.as_tensor(v))
                                    for k, v in b.items()}, None)
        mgr.save(int(state.step), state, extra={"epoch": 1})
        mgr.flush()
    else:
        fresh = init_train_state(cfg, opt, spec["num_users"], spec["num_items"], mesh=mesh)
        state, meta = mgr.restore(fresh)
        assert meta["epoch"] == 1 and state.sharding is fresh.sharding
    return {"state": bridge.gathered_state_to_numpy(state),
            "shard_rows": state.params["user_embedding"].shape[0]}


def collectives(rank, world, workdir, spec):
    """The mesh's axes (sizes, indices) and the four collectives along each,
    on inputs that name their rank; and ``all_gather_grad``'s backward."""
    cfg = _config({"mesh.num_model": spec["num_model"]})
    mesh = _mesh(cfg)
    out = {"mesh": {"num_data": mesh.num_data, "num_model": mesh.num_model, "rank": mesh.rank,
                    "d": mesh.d_idx, "m": mesh.m_idx, "backend": mesh.backend}}
    for name in ("data", "model", "combined"):
        ax = mesh.axis(name)
        x = torch.arange(2 * ax.size, dtype=torch.float32) + 100 * rank
        g = torch.full((3, 2), float(rank)).requires_grad_()
        from twotower_tpu_torch.parallel.mesh import all_gather_grad

        gathered = all_gather_grad(g, ax)
        (gathered * torch.arange(gathered.shape[0], dtype=torch.float32)[:, None]).sum().backward()
        out[name] = {"size": ax.size, "index": ax.index, "all_reduce": ax.all_reduce(x),
                     "all_gather": ax.all_gather(x), "all_to_all": ax.all_to_all(x),
                     "reduce_scatter": ax.reduce_scatter(x), "grad": g.grad}
    return out


def shards(rank, world, workdir, spec):
    """This rank's shard of the bridged state (as it is, and gathered back),
    and a fresh ``init_train_state(mesh=)`` gathered."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.training.state import init_train_state, make_optimizer

    cfg = _config(spec["overrides"])
    mesh = _mesh(cfg)
    state = bridge.sharded_state_from_numpy(spec["state"], mesh, cfg)
    fresh = init_train_state(cfg, make_optimizer(cfg.training), spec["num_users"],
                             spec["num_items"], mesh=mesh)
    return {"local": bridge.state_to_numpy(state),
            "gathered": bridge.gathered_state_to_numpy(state),
            "fresh": bridge.gathered_state_to_numpy(fresh),
            "sparse": state.sharding.sparse_mesh}

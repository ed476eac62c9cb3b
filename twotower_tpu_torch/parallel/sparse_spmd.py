"""The sharded SPARSE train step: all-to-all lookups, model-axis tower
sharding, the fused loss in block form, and the distributed row update.

Counterpart of ``twotower_tpu/parallel/sparse_spmd.py``; one process a
rank runs the body that JAX's ``shard_map`` runs a device:

- Tables and their packed lazy-Adam moments are row-sharded over the
  combined ``(data, model)`` axis (``parallel/sharding.py``); the towers
  and their optimizer state are replicated; the batch splits over
  ``data``, so the step takes this rank's ``B/D`` rows.
- Each model peer takes a ``1/S`` slice of its data shard's ids and looks
  their rows up over the combined axis (``a2a.alltoall_lookup``). The rows
  stay per peer: each peer runs the towers on its ``B/(D*S)`` rows, and
  only the F-wide tower outputs are all-gathered along ``model`` (and,
  unless ``retrieval.shard_local_negatives``, along ``data``) to form the
  item columns. The gathers' backward reduce-scatters the column
  cotangents to their owners.
- The in-batch loss is each peer's ``[B/(D*S), B]`` block (or ``[B/(D*S),
  B/D]`` with shard-local columns) at its global ``row_offset``, through
  the fused kernels on a CUDA device and the plain block on the CPU
  (``ops.dispatch.in_batch_softmax_block_auto``; a block the kernels do not
  cover raises). The uniform and mixed losses run plain PyTorch, as on one
  device.
- Dense gradients are all-reduced over the combined axis (in bfloat16
  where ``mesh.dense_grad_dtype`` says so) and applied by the dense
  optimizer; each peer routes its rows' gradients to their owners
  (``a2a.alltoall_row_update``), where lazy Adam updates the local rows.

The step has the one-device steps' signature, ``step(state, batch, rng,
log_q=None, item_tokens=None, *, clock=None, neg_ids=None)``: ``rng``
draws the sampled negatives (the same on every rank), each rank's dropout
masks come from its own generator (``step.dropout_gen``), ``clock`` makes
the step capturable in a CUDA graph, and ``neg_ids`` hands the negatives
in. Collectives carry fixed shapes: the a2a buckets are padded to their
static capacity.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.parallel.mesh import Mesh, all_gather_grad

logger = get_logger(__name__)


def use_sparse_mesh_path(config: Config) -> bool:
    """Whether the mesh step is the sparse one (JAX ``use_sparse_mesh_path``):
    every sampling mode has a sparse mesh branch; the dense mesh step is
    kept for what the sparse math does not model (non-Adam optimizers,
    weight decay: ``effective_sparse_updates``) and unsharded tables."""
    return bool(config.training.effective_sparse_updates() and config.mesh.shard_embeddings)


def _capacity(k: int, num_shards: int, factor: float) -> int:
    """A2a bucket capacity for ``k`` local ids over ``num_shards`` owners:
    ``k`` (never drops) for ``factor <= 0``, else ``factor`` times the
    uniform expectation rounded up to 8, within ``[8, k]``."""
    if factor <= 0:
        return k
    cap = -(-int(factor * k) // num_shards)
    cap = -(-cap // 8) * 8
    return max(8, min(cap, k))


def reduce_dense_grads(grads: list[torch.Tensor], axis, dtype: torch.dtype | None):
    """All-reduce a list of gradients over ``axis`` as one flat buffer,
    optionally in ``dtype`` (the sum is then taken in it), back in float32."""
    if not grads:
        return []
    flat = torch.cat([g.reshape(-1) for g in grads])
    if dtype is not None:
        flat = flat.to(dtype)
    flat = axis.all_reduce(flat).float()
    out, start = [], 0
    for g in grads:
        out.append(flat[start:start + g.numel()].view_as(g))
        start += g.numel()
    return out


def make_sparse_sharded_train_step(
    config: Config,
    optimizer,
    mesh: Mesh,
    state_template: Any = None,
    *,
    num_items: int | None = None,
):
    """Build the sharded sparse step (module docstring). ``state_template``
    (a sparse state sharded with ``sparse_mesh=True``) is checked for the
    layout the step needs."""
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.dispatch import in_batch_softmax_block_auto
    from twotower_tpu_torch.ops.losses import (
        l2_penalty,
        mixed_softmax_block,
        uniform_softmax_block,
    )
    from twotower_tpu_torch.parallel.a2a import alltoall_lookup, alltoall_row_update
    from twotower_tpu_torch.training.sparse import make_lr_fn, split_params
    from twotower_tpu_torch.training.state import lr_at, tree_leaves, tree_map

    mcfg, rcfg, tcfg, mcfg_mesh = config.model, config.retrieval, config.training, config.mesh
    num_data, num_model, world = mesh.num_data, mesh.num_model, mesh.world
    d_idx, m_idx = mesh.d_idx, mesh.m_idx
    mode = rcfg.candidate_sampling
    mixed, uniform = mode == "mixed", mode == "uniform"
    sample_negs = mixed or uniform
    num_negs = rcfg.num_negatives if sample_negs else 0
    if sample_negs and num_items is None:
        raise ValueError(f"{mode} candidate sampling needs num_items")
    # Negative counts that do not split over the model axis are padded for
    # the exchange only (the pad repeats neg_ids[0] and is sliced off after
    # the output gather): the loss sees exactly num_negatives.
    negs_padded = -(-num_negs // num_model) * num_model if sample_negs else 0
    log_uniform = -math.log(num_items) if mixed else 0.0
    local_cols = bool(rcfg.shard_local_negatives) and not uniform
    batch_size = tcfg.batch_size
    if batch_size % world:
        raise ValueError(f"training.batch_size={batch_size} must divide by num_data*num_model"
                         f"={num_data}x{num_model} for the sparse mesh step")
    b_local = batch_size // num_data
    k_rows = b_local // num_model  # tower rows a model peer
    if state_template is not None:
        if state_template.table_state is None:
            raise ValueError("sparse mesh step needs a sparse TrainState "
                             "(TrainState.for_config with sparse_table_updates on)")
        sh = state_template.sharding
        if sh is None or not sh.sparse_mesh:
            raise ValueError("sparse mesh step needs a state sharded with sparse_mesh=True "
                             "(parallel.sharding.shard_state)")
    grad_dtype = torch.bfloat16 if mcfg_mesh.dense_grad_dtype == "bfloat16" else None
    cap_factor = mcfg_mesh.a2a_capacity_factor
    lr_fn = make_lr_fn(tcfg)
    logger.info(
        "sparse mesh step: mesh=(%s=%d, %s=%d), local batch %d, %d tower rows a peer, "
        "columns %s, dense grads all-reduced in %s, %s loss on %s",
        mcfg_mesh.data_axis, num_data, mcfg_mesh.model_axis, num_model, b_local, k_rows,
        "shard-local" if local_cols else "global", mcfg_mesh.dense_grad_dtype, mode,
        mesh.device,
    )
    dropout_gen = torch.Generator(device=mesh.device).manual_seed(tcfg.seed + 1 + mesh.rank)

    def peer(x: torch.Tensor, k: int) -> torch.Tensor:
        return x[m_idx * k:(m_idx + 1) * k]

    def step(state, batch: dict, rng, log_q=None, item_tokens=None, *,
             clock: torch.Tensor | None = None, neg_ids: torch.Tensor | None = None):
        tables, dense = split_params(state.params)
        ids_u, ids_i = batch["user_idx"], batch["item_idx"]
        w = batch.get("weight")
        w = torch.ones(ids_u.shape[0], device=ids_u.device) if w is None else w.float()
        if ids_u.shape[0] != b_local:
            raise ValueError(f"the sparse mesh step takes this rank's {b_local} batch rows, "
                             f"got {ids_u.shape[0]}")
        drops = []

        def gather(name, flat_ids):
            k = flat_ids.shape[0] // num_model
            my = peer(flat_ids, k)
            rows, drop = alltoall_lookup(tables[name], my, mesh.combined,
                                         capacity=_capacity(k, world, cap_factor),
                                         return_stats=True)
            drops.append(drop)
            return rows, my

        with torch.no_grad():
            u_rows, my_u = gather("user_embedding", ids_u)
            i_rows, my_i = gather("item_embedding", ids_i)
            rows = {"u": u_rows, "i": i_rows}
            tokens_m = None
            if item_tokens is not None:
                tokens = item_tokens[ids_i]  # [b_local, T]
                t_width = tokens.shape[1]
                # Flattened-token slice m of the data shard is exactly rows
                # [m*k, (m+1)*k)'s tokens, aligned with the item-row slice.
                tok_flat, _ = gather("text_embedding", tokens.reshape(-1))
                rows["tok"] = tok_flat.view(k_rows, t_width, -1)
                tokens_m = peer(tokens.reshape(-1), k_rows * t_width).view(k_rows, t_width)
            if sample_negs:
                if neg_ids is None:
                    neg_ids = torch.randint(0, num_items, (num_negs,), generator=rng,
                                            device=ids_i.device)
                neg_ids = neg_ids.to(device=ids_i.device, dtype=ids_i.dtype)
                pad = negs_padded - num_negs
                neg_x = torch.cat([neg_ids, neg_ids[:1].expand(pad)]) if pad else neg_ids
                rows["neg"], my_neg = gather("item_embedding", neg_x)
                k_neg = negs_padded // num_model
                if item_tokens is not None:
                    neg_tokens = item_tokens[neg_x]
                    neg_tok_flat, _ = gather("text_embedding", neg_tokens.reshape(-1))
                    rows["neg_tok"] = neg_tok_flat.view(k_neg, t_width, -1)
                    neg_tokens_m = peer(neg_tokens.reshape(-1), k_neg * t_width).view(
                        k_neg, t_width)
        # The loss differentiates w.r.t. the looked-up rows.
        rows = {k: v.detach().requires_grad_() for k, v in rows.items()}
        u_rows, i_rows, tok_rows = rows["u"], rows["i"], rows.get("tok")
        row_offset = d_idx * b_local + m_idx * k_rows
        w_m = peer(w, k_rows)
        diff = tree_map(lambda t: t.detach().requires_grad_(), dense)
        leaves = tree_leaves(diff)
        with torch.enable_grad():
            u_emb = two_tower.apply_user_tower(diff, u_rows, mcfg, train=True,
                                               dropout_gen=dropout_gen)
            item_in = i_rows
            if tokens_m is not None:
                item_in = item_in + two_tower.pool_rows(tok_rows, tokens_m)
            i_emb_m = two_tower.apply_item_tower(diff, item_in, mcfg, train=True,
                                                 dropout_gen=dropout_gen)
            lq = log_q if rcfg.logq_correction else None
            if sample_negs:
                neg_in = rows["neg"]
                if "neg_tok" in rows:
                    neg_in = neg_in + two_tower.pool_rows(rows["neg_tok"], neg_tokens_m)
                neg_out_m = two_tower.apply_item_tower(diff, neg_in, mcfg, train=True,
                                                       dropout_gen=dropout_gen)
                neg_emb = all_gather_grad(neg_out_m, mesh.model)[:num_negs]
            if uniform:
                # Each row scores its own positive: positives never leave the peer.
                per_ex, correct, raw_diag = uniform_softmax_block(
                    u_emb, i_emb_m, neg_emb, my_i, neg_ids, temperature=rcfg.temperature)
            else:
                i_cols = all_gather_grad(i_emb_m, mesh.model)  # the data shard's columns
                if local_cols:
                    v_all, idx_all, w_all, offs = i_cols, ids_i, w, m_idx * k_rows
                else:
                    v_all = all_gather_grad(i_cols, mesh.data)
                    idx_all = mesh.data.all_gather(ids_i)
                    w_all = mesh.data.all_gather(w)
                    offs = row_offset
                if mixed:
                    per_ex, correct, raw_diag = mixed_softmax_block(
                        u_emb, v_all, idx_all, offs, neg_emb, neg_ids,
                        temperature=rcfg.temperature, log_q=lq, log_uniform=log_uniform,
                        weights_all=w_all)
                else:
                    per_ex, correct, raw_diag = in_batch_softmax_block_auto(
                        u_emb, v_all, idx_all, offs, temperature=rcfg.temperature,
                        log_q=lq, weights_all=w_all)
            denom = torch.clamp(mesh.data.all_reduce(w.sum()), min=1.0)
            # This peer's share of the global loss: the shares sum to it
            # over the combined axis.
            loss_share = torch.sum(per_ex * w_m) / denom
            if mcfg.l2_regularization > 0:
                reg = l2_penalty(diff, []) / world + l2_penalty({}, [u_rows, i_rows])
                loss_share = loss_share + mcfg.l2_regularization * reg
            grads = torch.autograd.grad(loss_share, [*leaves, *rows.values()])
        row_grad = dict(zip(rows, grads[len(leaves):]))
        # Peers tower distinct rows: the dense gradient is the sum over the
        # combined axis.
        dense_grads = reduce_dense_grads(list(grads[:len(leaves)]), mesh.combined, grad_dtype)
        if clock is None:
            lr, step_num = lr_fn(state.step), state.step + 1
        else:
            lr, step_num = lr_at(tcfg, clock), clock + 1.0
        new_opt = optimizer.update_(dense, dense_grads, state.opt_state, clock=clock,
                                    lr=None if clock is None else lr)
        item_ids, item_grads = my_i, row_grad["i"]
        if sample_negs:
            item_ids = torch.cat([my_i, my_neg])
            item_grads = torch.cat([item_grads, row_grad["neg"]])
        work = {"user_embedding": (my_u, row_grad["u"]),
                "item_embedding": (item_ids, item_grads)}
        if tokens_m is not None:
            e = tok_rows.shape[-1]
            tok_ids, tok_grads = tokens_m.reshape(-1), row_grad["tok"].reshape(-1, e)
            if "neg_tok" in rows:
                tok_ids = torch.cat([tok_ids, neg_tokens_m.reshape(-1)])
                tok_grads = torch.cat([tok_grads, row_grad["neg_tok"].reshape(-1, e)])
            work["text_embedding"] = (tok_ids, tok_grads)
        norm_sq = []
        for name, (ids, g) in work.items():
            nsq, drop = alltoall_row_update(
                tables[name], state.table_state[name]["moments"], ids, g, mesh.combined,
                capacity=_capacity(ids.shape[0], world, cap_factor), lr=lr, step=step_num)
            norm_sq.append(nsq)
            drops.append(drop)
        if clock is not None:
            clock.add_(1.0)
        sums = mesh.combined.all_reduce(torch.stack([
            loss_share.detach(),
            torch.sum(correct * w_m),
            torch.sum(raw_diag * w_m),
            sum(norm_sq),
            sum(d.float() for d in drops),
        ]))
        denom = denom.detach()
        dense_sq = sum(torch.sum(g * g) for g in dense_grads)
        metrics = {
            "loss": sums[0],
            "accuracy": sums[1] / denom,
            "logits_mean": sums[2] / denom,
            "grad_norm": torch.sqrt(dense_sq + sums[3]),
            "dropped_ids": sums[4],
        }
        new_state = type(state)(step=state.step + 1, params=state.params, opt_state=new_opt,
                                table_state=state.table_state, sharding=state.sharding)
        return new_state, metrics

    step.dropout_gen = dropout_gen
    return step

"""Mesh-wide train and eval steps: the in-batch loss in block form, the dense
mesh step, the sparse/dense dispatch, and the sharded evaluation.

Counterpart of ``twotower_tpu/parallel/spmd.py``. Where JAX partitions one
program over the mesh (GSPMD, with the fused loss as a ``shard_map``
island), each rank here runs its share with explicit collectives:

- ``make_mesh_loss``: each data rank scores its ``[B/D, B]`` block against
  the item columns all-gathered along ``data``, at ``row_offset =
  d * B/D``, through the fused kernels on a CUDA device (the plain block
  elsewhere), and returns per-example values; the weighted reduction is
  the caller's. The all-gather's backward reduce-scatters the column
  cotangents to their owners.
- ``make_dense_sharded_step``: what the sparse math does not model
  (non-Adam optimizers, weight decay, ``shard_embeddings=false``). Towers
  replicated; tables row-sharded over ``model`` and looked up with
  ``psum_lookup``; gradients summed over ``data`` (the model peers of a
  data shard compute the same thing, so each takes ``1/S`` of the loss and
  the tower gradients are summed over the combined axis); the optimizer
  runs on every leaf, table shards included.
- ``make_sharded_train_step``: the sparse step
  (``parallel/sparse_spmd.py``) where ``use_sparse_mesh_path``, else the
  dense one.
- ``make_sharded_eval_step``: the encoded corpus row-sharded over
  ``model`` (padded as JAX pads it), each shard encoded from table rows
  looked up from their owners (no rank gathers a table), queries split
  over ``data``, the per-shard candidates merged over ``model``
  (``ops.topk``'s sharded searches) and the metric sums all-reduced over
  ``data``, so every rank sees the same metrics.

The device-resident epoch on a mesh is ``training.device_loop``'s epoch
program with the mesh step (``make_epoch_fn(mesh=...)``).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.parallel.mesh import Mesh, all_gather_grad
from twotower_tpu_torch.parallel.sparse_spmd import (
    make_sparse_sharded_train_step,
    reduce_dense_grads,
    use_sparse_mesh_path,
)

logger = get_logger(__name__)


def make_mesh_loss(mesh: Mesh, config: Config):
    """The in-batch loss over the ``data`` axis in block form: ``loss(
    user_emb, item_emb, item_idx, *, temperature, log_q=None, weights=None)
    -> (per_example, correct, raw_diag)`` for this data shard's rows
    (``[B/D, F]`` embeddings, ``[B/D]`` ids and weights), through the fused
    kernels on a CUDA device and the plain block on the CPU
    (``ops.dispatch.in_batch_softmax_block_auto``)."""
    from twotower_tpu_torch.ops.dispatch import in_batch_softmax_block_auto

    def loss(user_emb, item_emb, item_idx, *, temperature, log_q=None, weights=None):
        v_all = all_gather_grad(item_emb, mesh.data)
        idx_all = mesh.data.all_gather(item_idx)
        w_all = None if weights is None else mesh.data.all_gather(weights.float())
        return in_batch_softmax_block_auto(user_emb, v_all, idx_all,
                                           mesh.d_idx * user_emb.shape[0],
                                           temperature=temperature, log_q=log_q,
                                           weights_all=w_all)

    return loss


def make_dense_sharded_step(
    config: Config,
    optimizer,
    mesh: Mesh,
    state_template: Any = None,
    *,
    num_items: int | None = None,
):
    """The dense mesh step (module docstring), with the one-device steps'
    signature ``step(state, batch, rng, log_q=None, item_tokens=None, *,
    clock=None, neg_ids=None)`` on this rank's data shard of the batch.
    ``rng`` draws the sampled negatives (the same on every rank); each data
    shard's dropout masks come from its own generator, the same on its
    model peers (``step.dropout_gen``)."""
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.losses import (
        l2_penalty,
        mixed_softmax_block,
        uniform_softmax_block,
    )
    from twotower_tpu_torch.parallel.a2a import psum_lookup
    from twotower_tpu_torch.parallel.sharding import table_axis
    from twotower_tpu_torch.training.sparse import TABLE_NAMES
    from twotower_tpu_torch.training.state import lr_at, tree_leaves, tree_map

    mcfg, rcfg, tcfg = config.model, config.retrieval, config.training
    mode = rcfg.candidate_sampling
    sample_negs = mode in ("uniform", "mixed")
    if sample_negs and num_items is None:
        raise ValueError(f"{mode} candidate sampling needs num_items")
    if tcfg.batch_size % mesh.num_data:
        raise ValueError(f"training.batch_size={tcfg.batch_size} must divide by "
                         f"num_data={mesh.num_data}")
    if state_template is not None and state_template.table_state is not None:
        raise ValueError("the dense mesh step takes a dense TrainState")
    b_local = tcfg.batch_size // mesh.num_data
    sharded = table_axis(config.mesh) is not None
    n_model = mesh.num_model
    mesh_loss = make_mesh_loss(mesh, config) if mode == "in_batch" else None
    dropout_gen = torch.Generator(device=mesh.device).manual_seed(tcfg.seed + 1 + mesh.d_idx)
    logger.info("dense mesh step: mesh=(%d, %d), local batch %d, tables %s", mesh.num_data,
                n_model, b_local, "row-sharded over model" if sharded else "replicated")

    def lookup(table, ids):
        if sharded:
            return psum_lookup(table, ids.reshape(-1), mesh.model).view(*ids.shape, -1)
        return table[ids]

    def step(state, batch: dict, rng, log_q=None, item_tokens=None, *,
             clock: torch.Tensor | None = None, neg_ids: torch.Tensor | None = None):
        ids_u, ids_i = batch["user_idx"], batch["item_idx"]
        w = batch.get("weight")
        w = torch.ones(ids_u.shape[0], device=ids_u.device) if w is None else w.float()
        if sample_negs:
            if neg_ids is None:
                neg_ids = torch.randint(0, num_items, (rcfg.num_negatives,), generator=rng,
                                        device=ids_i.device)
            neg_ids = neg_ids.to(device=ids_i.device, dtype=ids_i.dtype)
        diff = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        leaves = tree_leaves(diff)
        lq = log_q if rcfg.logq_correction else None
        with torch.enable_grad():
            u_rows = lookup(diff["user_embedding"], ids_u)
            i_rows = lookup(diff["item_embedding"], ids_i)
            u_emb = two_tower.apply_user_tower(diff, u_rows, mcfg, train=True,
                                               dropout_gen=dropout_gen)
            item_in = i_rows
            if item_tokens is not None:
                tokens = item_tokens[ids_i]
                item_in = item_in + two_tower.pool_rows(
                    lookup(diff["text_embedding"], tokens), tokens)
            i_emb = two_tower.apply_item_tower(diff, item_in, mcfg, train=True,
                                               dropout_gen=dropout_gen)
            if sample_negs:
                neg_in = lookup(diff["item_embedding"], neg_ids)
                if item_tokens is not None:
                    neg_tokens = item_tokens[neg_ids]
                    neg_in = neg_in + two_tower.pool_rows(
                        lookup(diff["text_embedding"], neg_tokens), neg_tokens)
                neg_emb = two_tower.apply_item_tower(diff, neg_in, mcfg, train=True,
                                                     dropout_gen=dropout_gen)
            if mode == "uniform":
                per_ex, correct, raw_diag = uniform_softmax_block(
                    u_emb, i_emb, neg_emb, ids_i, neg_ids, temperature=rcfg.temperature)
            elif mode == "mixed":
                per_ex, correct, raw_diag = mixed_softmax_block(
                    u_emb, all_gather_grad(i_emb, mesh.data), mesh.data.all_gather(ids_i),
                    mesh.d_idx * b_local, neg_emb, neg_ids, temperature=rcfg.temperature,
                    log_q=lq, log_uniform=-math.log(num_items),
                    weights_all=mesh.data.all_gather(w))
            else:
                per_ex, correct, raw_diag = mesh_loss(
                    u_emb, i_emb, ids_i, temperature=rcfg.temperature, log_q=lq, weights=w)
            denom = torch.clamp(mesh.data.all_reduce(w.sum()), min=1.0)
            loss_d = torch.sum(per_ex * w) / denom  # this data shard's share
            if mcfg.l2_regularization > 0:
                towers = {k: diff[k] for k in ("user_tower", "item_tower")}
                reg = l2_penalty(towers, []) / mesh.num_data + l2_penalty({}, [u_rows, i_rows])
                loss_d = loss_d + mcfg.l2_regularization * reg
            # The model peers of a data shard hold the same loss: each takes
            # 1/S of it, so the losses of all ranks sum to the global one.
            grads = torch.autograd.grad(loss_d / n_model, leaves)
        names = [n for n in sorted(diff) for _ in tree_leaves(diff[n])]
        flat, tbl = [], []
        for name, g in zip(names, grads):
            (tbl if name in TABLE_NAMES and sharded else flat).append(g)
        # Towers (and replicated tables): summed over every rank. Table
        # shards: summed over the data shards that share them.
        flat = iter(reduce_dense_grads(flat, mesh.combined, None))
        tbl = iter(reduce_dense_grads(tbl, mesh.data, None))
        grads = [next(tbl) if name in TABLE_NAMES and sharded else next(flat) for name in names]
        lr = None if clock is None else lr_at(tcfg, clock)
        new_opt = optimizer.update_(state.params, grads, state.opt_state, clock=clock, lr=lr)
        if clock is not None:
            clock.add_(1.0)
        dense_sq = sum(torch.sum(g * g) for n, g in zip(names, grads)
                       if not (n in TABLE_NAMES and sharded))
        tbl_sq = sum((torch.sum(g * g) for n, g in zip(names, grads)
                      if n in TABLE_NAMES and sharded), torch.zeros((), device=w.device))
        sums = mesh.data.all_reduce(torch.stack([
            loss_d.detach(), torch.sum(correct * w), torch.sum(raw_diag * w)]))
        denom = denom.detach()
        metrics = {
            "loss": sums[0],
            "accuracy": sums[1] / denom,
            "logits_mean": sums[2] / denom,
            "grad_norm": torch.sqrt(dense_sq + mesh.model.all_reduce(tbl_sq)),
        }
        new_state = type(state)(step=state.step + 1, params=state.params, opt_state=new_opt,
                                sharding=state.sharding)
        return new_state, metrics

    step.dropout_gen = dropout_gen
    return step


def make_sharded_train_step(
    config: Config,
    optimizer,
    mesh: Mesh,
    state_template: Any = None,
    *,
    num_items: int | None = None,
):
    """The mesh step for ``config``: the sparse step where
    ``use_sparse_mesh_path``, else the dense one (JAX ``_build_mesh_step``'s
    rule)."""
    if use_sparse_mesh_path(config):
        return make_sparse_sharded_train_step(config, optimizer, mesh, state_template,
                                              num_items=num_items)
    return make_dense_sharded_step(config, optimizer, mesh, state_template,
                                   num_items=num_items)


EXACT_SHARD_ALIGN = 131072


def corpus_shard_rows(num_items: int, num_model: int, exact: bool) -> int:
    """Rows of each model shard of the encoded corpus: ``ceil(N / S)``,
    aligned to 131072 when exact and at least that large (JAX
    ``make_sharded_eval_step``'s padding)."""
    local = -(-num_items // num_model)
    if exact and local >= EXACT_SHARD_ALIGN:
        local = -(-local // EXACT_SHARD_ALIGN) * EXACT_SHARD_ALIGN
    return local


# Ids a rank looks up in one all-to-all while encoding the corpus: bounds the
# exchange buffers and the tower's activations (the corpus shard and the
# scores are the evaluation's only larger buffers).
ENCODE_IDS = 16384


def make_sharded_eval_step(
    config: Config,
    mesh: Mesh,
    num_items: int,
    max_k: int,
    *,
    item_tokens: torch.Tensor | None = None,
    sharding: Any = None,
):
    """``(encode, eval_batch)`` of the sharded evaluation (module
    docstring), on parameters in their mesh layout (``sharding``, a
    ``StateSharding``; None: whole on every rank). No rank gathers a
    table: ``encode(params)`` returns ``(params, corpus_shard)``, this
    rank's ``[rows, D]`` model shard of the encoded corpus (corpus rows
    ``[m * rows, (m + 1) * rows)``, zero past ``num_items``), whose item
    rows (and text rows) are looked up from their owners with
    ``alltoall_lookup`` in chunks of ``ENCODE_IDS`` ids, the same number
    of calls on every rank; ``eval_batch(params, corpus_shard, user_idx,
    true_item, weight)`` takes this rank's data shard of one query batch,
    looks its user rows up the same way (JAX's GSPMD gather) and returns
    the weighted metric sums and the weight (``[len(keys) + 1]``, over this
    data shard only: the caller all-reduces them over ``data``), with the
    keys ``eval_keys(config, max_k)``."""
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.topk import topk_mips_approx_sharded, topk_mips_sharded
    from twotower_tpu_torch.parallel.a2a import alltoall_lookup
    from twotower_tpu_torch.parallel.sharding import table_axis

    mcfg = config.model
    exact = config.retrieval.eval_exact
    local_rows = corpus_shard_rows(num_items, mesh.num_model, exact)
    lo = mesh.m_idx * local_rows
    hi = min(lo + local_rows, num_items)
    ks = eval_ks(config, max_k)
    dtype = getattr(torch, config.retrieval.eval_corpus_dtype)
    axis_name = None if sharding is None else table_axis(config.mesh,
                                                          sparse_mesh=sharding.sparse_mesh)
    width = 1 + (0 if item_tokens is None else item_tokens.shape[1])
    chunk = max(1, min(ENCODE_IDS // width, local_rows))

    def lookup(table, ids):
        if axis_name is None:
            return table[ids]
        return alltoall_lookup(table, ids.reshape(-1), mesh.axis(axis_name)).view(
            *ids.shape, -1)

    @torch.no_grad()
    def encode(params):
        shard = torch.zeros((local_rows, list(mcfg.item_tower_dims)[-1]), dtype=dtype,
                            device=mesh.device)
        for start in range(0, local_rows, chunk):
            # Every rank runs every chunk (its lookups are collectives); rows
            # past num_items look up item 0 and are dropped.
            n = min(chunk, local_rows - start)
            idx = torch.arange(lo + start, lo + start + chunk, device=mesh.device)
            idx = torch.where(idx < num_items, idx, 0)
            rows = lookup(params["item_embedding"], idx)
            if item_tokens is not None:
                tokens = item_tokens[idx]
                rows = rows + two_tower.pool_rows(lookup(params["text_embedding"], tokens),
                                                  tokens)
            real = max(0, min(n, hi - lo - start))
            if real:
                emb = two_tower.apply_item_tower(params, rows[:real], mcfg, train=False)
                shard[start:start + real] = emb.to(dtype)
        return params, shard

    @torch.no_grad()
    def eval_batch(params, corpus_shard, user_idx, true_item, weight):
        from twotower_tpu_torch.evaluation.metrics import rank_of_true_item

        user_emb = two_tower.apply_user_tower(
            params, lookup(params["user_embedding"], user_idx), mcfg, train=False)
        if exact:
            _, topk_idx = topk_mips_sharded(user_emb, corpus_shard, max_k, axis=mesh.model,
                                            num_items=num_items)
        else:
            _, topk_idx = topk_mips_approx_sharded(
                user_emb, corpus_shard, max_k, axis=mesh.model, num_items=num_items,
                recall_target=config.serving.recall_target)
        rank = rank_of_true_item(topk_idx, true_item).float()
        w = weight.float()
        gain = 1.0 / torch.log2(rank + 2.0)
        sums = []
        for k in ks:
            sums.append(((rank < k).float() * w).sum())
        for k in ks:
            sums.append(((rank < k).float() * gain * w).sum())
        sums.append(((rank < max_k).float() / (rank + 1.0) * w).sum())
        sums.append(w.sum())
        return torch.stack(sums)

    return encode, eval_batch


def eval_ks(config: Config, max_k: int) -> tuple[int, ...]:
    """The cutoffs the metrics are taken at (the evaluator's tiny-corpus
    rule: ``(max_k,)`` when every configured k exceeds it)."""
    return tuple(k for k in sorted(config.retrieval.top_k_eval) if k <= max_k) or (max_k,)


def eval_keys(config: Config, max_k: int) -> list[str]:
    ks = eval_ks(config, max_k)
    return [f"recall@{k}" for k in ks] + [f"ndcg@{k}" for k in ks] + ["mrr"]

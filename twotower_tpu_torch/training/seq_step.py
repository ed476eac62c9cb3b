"""The train step of the sequence user tower (``model.user_tower:
sequence``): one packed stream of user windows a step.

A batch is a stream of ``S`` slots (``hist_idx``, ``item_idx``, ``pos``,
``weight``, each ``[S]``): slot ``t`` reads the item ``hist_idx[t]``, sits
at place ``pos[t]`` of its user's window, and is scored against its user's
next item ``item_idx[t]``. The step gathers the item table's rows at both
places (the history slots and the targets), runs the sequence tower over the
stream (``models/seq_tower.py``) and the item tower over the targets (with
its dropout), scores every slot against every target by the in-batch
softmax with log-Q correction (``ops.dispatch``: the fused kernels on CUDA),
adds the balance loss and L2 (item tower kernels and the gathered rows),
and differentiates w.r.t. the dense weights and both sets of gathered rows.
The dense weights (sequence and item towers) take Adam in place
(``torch._fused_adam_``: the update of ``optax.adam`` in one kernel per
group of leaves); both sources' row gradients go to one lazy-Adam update of
the item table (``training.sparse.sparse_table_updates``), so a row read as
history and as a target takes their sum.

The step's signature and ``clock`` are the sparse step's
(``training.sparse.make_sparse_step_fn``), so the device loop captures it
as a CUDA graph, and the loop permutes whole streams
(``step.permutes_streams``). It marks its phases for a timed capture:
``forward`` before the head, ``backward`` before ``autograd.grad``, ``optimizer`` and
``rows``; the tower marks its layers' parts on the way forward and on the
gradient's way back (``StepPhases(boundaries=None)``). Each MoE layer's
routed slots per expert are added into the counter ``moe.routed_tokens``
(``[L_moe, N]``) on the device.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any

import torch

from twotower_tpu_torch.training.sparse import (
    make_lr_fn,
    sparse_table_updates,
    split_params,
)
from twotower_tpu_torch.training.state import Adam, TrainState, lr_at, tree_leaves, tree_map
from twotower_tpu_torch.utils import profiling
from twotower_tpu_torch.utils.profiling import step_phase

COUNTER = "moe.routed_tokens"


def adam_fused_(params: list, grads: list, mu: list, nu: list, opt: Adam, *, lr, step) -> None:
    """``optax.adam`` over the leaves, in place, by ``torch._fused_adam_``
    (``lr``: a float or a 0-d tensor; ``step``: the count after this update,
    an int or a 0-d float32 tensor on the device)."""
    dev = params[0].device
    if not isinstance(step, torch.Tensor):
        step = torch.tensor(float(step), device=dev)
    torch._fused_adam_(params, list(grads), mu, nu, [], [step] * len(params), amsgrad=False,
                       lr=lr, beta1=opt.b1, beta2=opt.b2, weight_decay=0.0, eps=opt.eps,
                       maximize=False)


def make_seq_step_fn(config, dense_optimizer):
    """The sequence tower's train step, ``step(state, batch, rng,
    log_q=None, item_tokens=None, *, clock=None, neg_ids=None)``: the
    in-batch softmax over the stream's slots, lazy Adam on the item table's
    rows, Adam on the rest."""
    from twotower_tpu_torch.models import seq_tower, two_tower
    from twotower_tpu_torch.ops.dispatch import in_batch_softmax_loss_auto
    from twotower_tpu_torch.ops.losses import l2_penalty

    mcfg, rcfg, tcfg = config.model, config.retrieval, config.training
    if rcfg.candidate_sampling != "in_batch":
        raise ValueError("the sequence user tower trains with in_batch candidate sampling only")
    if not isinstance(dense_optimizer, Adam) or not tcfg.effective_sparse_updates():
        raise ValueError("the sequence user tower trains with adam, no weight decay and "
                         "sparse table updates")
    lr_fn = make_lr_fn(tcfg)
    n_moe = mcfg.sequence.num_moe_layers

    def step(state: TrainState, batch: dict, rng: torch.Generator | None,
             log_q: torch.Tensor | None = None, item_tokens: torch.Tensor | None = None, *,
             clock: torch.Tensor | None = None,
             neg_ids: torch.Tensor | None = None) -> tuple[TrainState, dict[str, Any]]:
        if item_tokens is not None or neg_ids is not None:
            raise ValueError("the sequence user tower takes no item tokens or sampled negatives")
        tables, dense = split_params(state.params)
        table = tables["item_embedding"]
        hist, items, weights = batch["hist_idx"], batch["item_idx"], batch["weight"]
        diff = tree_map(lambda t: t.detach().requires_grad_(), dense)
        h_rows = table[hist].requires_grad_()
        i_rows = table[items].requires_grad_()
        with torch.enable_grad():
            h, aux, counts = seq_tower.forward_stream(diff, h_rows, batch["pos"], weights, mcfg)
            u_emb = seq_tower.head(diff, h, mcfg)
            i_emb = two_tower.apply_item_tower(diff, i_rows, mcfg, train=True, dropout_gen=rng)
            lq = log_q if rcfg.logq_correction else None
            loss, metrics = in_batch_softmax_loss_auto(
                u_emb, i_emb, items, temperature=rcfg.temperature, log_q=lq, weights=weights)
            loss = loss + aux
            if mcfg.l2_regularization > 0:
                reg = l2_penalty({"item_tower": diff["item_tower"]}, [h_rows, i_rows])
                loss = loss + mcfg.l2_regularization * reg
            leaves = tree_leaves(diff)
            step_phase("backward")
            grads = torch.autograd.grad(loss, [*leaves, h_rows, i_rows])
        step_phase("optimizer")
        dense_grads = list(grads[:len(leaves)])
        if clock is None:
            lr, step_num = lr_fn(state.step), state.step + 1
        else:
            lr, step_num = lr_at(tcfg, clock), clock + 1.0
        opt = state.opt_state
        adam_fused_(tree_leaves(dense), dense_grads, tree_leaves(opt.mu), tree_leaves(opt.nu),
                    dense_optimizer, lr=lr, step=step_num)
        step_phase("rows")
        ids = torch.cat([hist, items])
        row_grads = torch.cat([grads[-2], grads[-1]])
        tbl_norm_sq = sparse_table_updates(
            tables, state.table_state, {"item_embedding": (ids, row_grads)}, lr=lr,
            step=step_num)
        if clock is not None:
            clock.add_(1.0)
        if n_moe:
            profiling.counter(COUNTER, (n_moe, mcfg.sequence.n_routed_experts),
                              counts.device).add_(counts)
        dense_sq = torch.stack(torch._foreach_norm(dense_grads)).square().sum()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["balance_loss"] = aux.detach()
        metrics["grad_norm"] = torch.sqrt(dense_sq + tbl_norm_sq)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=replace(opt, count=opt.count + 1),
                          table_state=state.table_state), metrics

    step.marks_phases = True
    step.phase_boundaries = None  # the tower's parts, in any order and number
    step.permutes_streams = True  # a batch is one packed stream: the epoch keeps it whole
    return step

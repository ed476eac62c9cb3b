"""Sparse (row-wise) embedding-table training step (PyTorch).

Counterpart of ``twotower_tpu/training/sparse.py``: differentiate w.r.t.
the *gathered rows*, dedup duplicate ids inside the batch (sort +
segment-sum, or the host-precomputed dedup of ``training/host_dedup.py``),
and add a lazy-Adam row update onto only the touched rows.

Semantics vs dense Adam: identical for every touched row on every step in
which it is touched; untouched rows carry no momentum decay (lazy Adam).

Duplicate/invalid targets are aimed at the table's reserved dead row
(``models.two_tower.dead_row``) with zero-masked updates, so every target
is unique or harmless. The updates are in-place ``index_add_`` on the
tables and the packed moments (the JAX step gets the same effect by
donating its state): no copy of the ~2.3 GB of tables and moments per step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from twotower_tpu_torch.config import TrainingConfig
from twotower_tpu_torch.training.state import (
    TrainState,
    _lr_schedule,
    f32_pow,
    lr_at,
    tree_leaves,
    tree_map,
)

TABLE_NAMES = ("user_embedding", "item_embedding", "text_embedding")


def split_params(params: dict) -> tuple[dict, dict]:
    """(tables, dense) partition of the parameter dict."""
    tables = {k: v for k, v in params.items() if k in TABLE_NAMES}
    dense = {k: v for k, v in params.items() if k not in TABLE_NAMES}
    return tables, dense


def init_table_state(tables: dict) -> dict:
    """Adam moments per table, PACKED as one ``[rows, 2E]`` tensor
    (``[:, :E]`` = mu, ``[:, E:]`` = nu): one gather and one scatter per
    table for both moments."""
    return {
        name: {"moments": t.new_zeros((t.shape[0], 2 * t.shape[1]))}
        for name, t in tables.items()
    }


def dedup_rows(
    ids: torch.Tensor, grads: torch.Tensor, dead: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine duplicate ids: stable sort + segment-sum with static shapes.

    Returns (targets [B], summed_grads [B, E], valid [B]): for each segment
    (unique id, ascending) one valid row holding the summed gradient and the
    id as target; all other rows target the dead row with zero updates.
    """
    b = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sid = ids[order].long()
    first = torch.ones(b, dtype=torch.bool, device=ids.device)
    first[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(first, 0) - 1  # segment per sorted row, in [0, B)
    summed = grads.new_zeros(grads.shape).index_add_(0, seg, grads[order])
    valid = torch.arange(b, device=ids.device) < first.sum()
    targets = torch.full((b,), dead, dtype=torch.long, device=ids.device)
    targets[seg] = sid  # every row of a segment writes the same id
    return targets, summed, valid


@torch.no_grad()
def adam_row_update_packed(
    table: torch.Tensor,
    moments: torch.Tensor,
    targets: torch.Tensor,
    grads: torch.Tensor,
    valid: torch.Tensor,
    *,
    lr: float | torch.Tensor,
    b1: float,
    b2: float,
    eps: float,
    step: int | torch.Tensor,
) -> None:
    """Lazy Adam on the targeted rows, in place, with mu/nu packed as
    ``moments[:, :E] / [:, E:]``. ``targets`` must be unique apart from
    zero-masked (``valid`` false) rows. ``lr`` and ``step`` are Python
    numbers, or 0-d float32 tensors on the device (``b ** step`` then
    computed there in float32, as the JAX update does), which a CUDA graph
    can capture."""
    e = table.shape[1]
    targets = targets.long()
    mask = valid.to(table.dtype)[:, None]
    mo_rows = moments[targets]
    new_mu = b1 * mo_rows[:, :e] + (1.0 - b1) * grads
    new_nu = b2 * mo_rows[:, e:] + (1.0 - b2) * (grads * grads)
    if isinstance(step, torch.Tensor):
        c1, c2 = 1.0 - torch.pow(b1, step), 1.0 - torch.pow(b2, step)
    else:
        c1, c2 = 1.0 - f32_pow(b1, step), 1.0 - f32_pow(b2, step)
    mu_hat = new_mu / c1
    nu_hat = new_nu / c2
    update = lr * mu_hat / (torch.sqrt(nu_hat) + eps)
    table.index_add_(0, targets, -update * mask)
    new_mo = torch.cat([new_mu, new_nu], dim=1)
    moments.index_add_(0, targets, (new_mo - mo_rows) * mask)


def make_lr_fn(config: TrainingConfig) -> Callable[[int], float]:
    """The same schedule the dense optimizer uses (training.state)."""
    if config.warmup_steps > 0 or config.decay_steps > 0:
        return _lr_schedule(config)
    return lambda step: config.learning_rate


@torch.no_grad()
def sparse_table_updates(
    tables: dict,
    table_state: dict,
    row_grads: dict[str, tuple[torch.Tensor, torch.Tensor]],
    *,
    lr: float | torch.Tensor,
    step: int | torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    pre: dict[str, tuple[torch.Tensor, torch.Tensor, torch.Tensor]] | None = None,
) -> torch.Tensor:
    """Apply row updates, in place, for every table with gradients.

    ``row_grads``: table name -> (ids [R], grads [R, E]); ids may repeat.
    ``pre``: optional host-precomputed dedup per table — ``name ->
    (targets [R], seg [R], valid [R])`` from ``training.host_dedup`` — which
    replaces the sort + segment dedup with one grads scatter-add
    (``summed[seg[j]] += grads[j]``). Returns the grad-norm-squared
    contribution of the tables.
    """
    from twotower_tpu_torch.models.two_tower import dead_row

    norm_sq = torch.zeros((), device=next(iter(tables.values())).device)
    for name, (ids, grads) in row_grads.items():
        table = tables[name]
        if pre is not None and name in pre:
            targets, seg, valid = pre[name]
            summed = torch.zeros_like(grads).index_add_(0, seg.long(), grads)
        else:
            targets, summed, valid = dedup_rows(ids, grads, dead_row(table))
        adam_row_update_packed(
            table,
            table_state[name]["moments"],
            targets,
            summed,
            valid,
            lr=lr,
            b1=b1,
            b2=b2,
            eps=eps,
            step=step,
        )
        norm_sq = norm_sq + torch.sum(summed * summed * valid.float()[:, None])
    return norm_sq


def make_sparse_step_fn(config, dense_optimizer, *, num_items: int | None = None):
    """Train step with sparse table updates: ``step(state, batch, rng,
    log_q=None, item_tokens=None, *, clock=None, neg_ids=None)`` with
    ``batch`` a dict of tensors on the state's device and ``rng`` a
    ``torch.Generator`` there (dropout masks and sampled negatives; None:
    the device's default generator).

    ``clock``, a 0-d float32 tensor on the device holding the step count
    before this step, makes the step capturable in a CUDA graph: the
    learning rate (``training.state.lr_at``) and both Adams' bias corrections are
    then computed from it on the device, and it is advanced in place, so a
    replay takes the next step's numbers. Without it they are Python
    numbers from ``state.step``, as in the host loop.

    Differentiates the loss w.r.t. the gathered embedding rows (not the
    tables), applies the dense optimizer to the towers and lazy-Adam row
    updates to the tables, all in place. Supports ``in_batch``, ``uniform``
    and ``mixed`` candidate sampling (``num_items`` is required for the
    latter two): those draw ``retrieval.num_negatives`` ids uniformly in
    ``[0, num_items)`` from ``rng`` on the device each step, run their rows
    through the item tower and update them with the positives' rows.
    ``neg_ids`` hands the step its negative ids instead (the parity tests
    pass the JAX package's threefry draw).

    ``item_tokens`` (``[num_items, T]`` int32 on the device) turns on the
    text tower: each item row (and each negative) gathers its tokens' rows
    of ``text_embedding``, pools them into its tower input
    (``two_tower.pool_rows``), and the token ids with their row gradients
    go to the lazy-Adam update of ``text_embedding`` (JAX
    ``sparse.py:231-261,318-327``). The PAD row 0 gets a zero gradient but
    counts as touched, as in the JAX step.
    """
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.ops.dispatch import in_batch_softmax_loss_auto
    from twotower_tpu_torch.ops.losses import (
        l2_penalty,
        mixed_sampled_softmax_loss,
        uniform_sampled_softmax_loss,
    )

    mcfg = config.model
    rcfg = config.retrieval
    lr_fn = make_lr_fn(config.training)
    mode = rcfg.candidate_sampling
    sample_negs = mode in ("uniform", "mixed")
    if sample_negs and num_items is None:
        raise ValueError(f"{mode} candidate sampling needs num_items")

    def step(state: TrainState, batch: dict, rng: torch.Generator | None,
             log_q: torch.Tensor | None = None,
             item_tokens: torch.Tensor | None = None, *,
             clock: torch.Tensor | None = None,
             neg_ids: torch.Tensor | None = None) -> tuple[TrainState, dict[str, Any]]:
        tables, dense = split_params(state.params)
        u_ids = batch["user_idx"]
        i_ids = batch["item_idx"]
        # Differentiate w.r.t. detached views of the dense params and the
        # gathered rows; the in-place updates below go to the originals.
        diff = tree_map(lambda t: t.detach().requires_grad_(), dense)
        u_rows = tables["user_embedding"][u_ids].requires_grad_()
        i_rows = tables["item_embedding"][i_ids].requires_grad_()
        rows = {"user": u_rows, "item": i_rows}
        tokens = None if item_tokens is None else item_tokens[i_ids]
        if tokens is not None:
            tok_rows = rows["text"] = tables["text_embedding"][tokens].requires_grad_()
        if sample_negs:
            if neg_ids is None:
                neg_ids = torch.randint(0, num_items, (rcfg.num_negatives,), generator=rng,
                                        device=i_ids.device)
            neg_ids = neg_ids.to(device=i_ids.device, dtype=i_ids.dtype)
            neg_rows = rows["neg"] = tables["item_embedding"][neg_ids].requires_grad_()
            if tokens is not None:
                neg_tokens = item_tokens[neg_ids]
                neg_tok_rows = rows["neg_text"] = (
                    tables["text_embedding"][neg_tokens].requires_grad_())
        with torch.enable_grad():
            u_emb = two_tower.apply_user_tower(
                diff, u_rows, mcfg, train=True, dropout_gen=rng
            )
            item_in = i_rows
            if tokens is not None:
                item_in = item_in + two_tower.pool_rows(tok_rows, tokens)
            i_emb = two_tower.apply_item_tower(
                diff, item_in, mcfg, train=True, dropout_gen=rng
            )
            weights = batch.get("weight")
            lq = log_q if rcfg.logq_correction else None
            if sample_negs:
                neg_in = neg_rows
                if tokens is not None:
                    neg_in = neg_in + two_tower.pool_rows(neg_tok_rows, neg_tokens)
                neg_emb = two_tower.apply_item_tower(
                    diff, neg_in, mcfg, train=True, dropout_gen=rng
                )
            if mode == "uniform":
                loss, metrics = uniform_sampled_softmax_loss(
                    u_emb, i_emb, neg_emb, temperature=rcfg.temperature, weights=weights,
                    pos_idx=i_ids, neg_idx=neg_ids,
                )
            elif mode == "mixed":
                loss, metrics = mixed_sampled_softmax_loss(
                    u_emb, i_emb, i_ids, neg_emb, neg_ids, temperature=rcfg.temperature,
                    log_q=lq, num_items=num_items, weights=weights,
                )
            else:
                loss, metrics = in_batch_softmax_loss_auto(
                    u_emb, i_emb, i_ids, temperature=rcfg.temperature, log_q=lq,
                    weights=weights,
                )
            if mcfg.l2_regularization > 0:
                reg = l2_penalty(diff, [u_rows, i_rows])
                loss = loss + mcfg.l2_regularization * reg
            leaves = tree_leaves(diff)
            grads = torch.autograd.grad(loss, [*leaves, *rows.values()])
        dense_grads = list(grads[: len(leaves)])
        row_grad = dict(zip(rows, grads[len(leaves):]))
        if clock is None:
            lr, step_num = lr_fn(state.step), state.step + 1
        else:
            lr, step_num = lr_at(config.training, clock), clock + 1.0
        # A flat list is its own leaf order, the one ``leaves`` came in.
        new_opt = dense_optimizer.update_(
            dense, dense_grads, state.opt_state, clock=clock, lr=None if clock is None else lr
        )

        i_grad = row_grad["item"]
        if sample_negs:
            i_ids, i_grad = torch.cat([i_ids, neg_ids]), torch.cat([i_grad, row_grad["neg"]])
        row_grads = {"user_embedding": (u_ids, row_grad["user"]),
                     "item_embedding": (i_ids, i_grad)}
        if tokens is not None:
            e = tok_rows.shape[-1]
            tok_ids, tok_grads = tokens.reshape(-1), row_grad["text"].reshape(-1, e)
            if sample_negs:
                tok_ids = torch.cat([tok_ids, neg_tokens.reshape(-1)])
                tok_grads = torch.cat([tok_grads, row_grad["neg_text"].reshape(-1, e)])
            row_grads["text_embedding"] = (tok_ids, tok_grads)
        pre = {}
        if "u_targets" in batch:
            pre["user_embedding"] = (batch["u_targets"], batch["u_seg"], batch["u_valid"])
        # Host dedup of the item table only without sampled negatives: the
        # host never sees the ids drawn on the device.
        if "i_targets" in batch and not sample_negs:
            pre["item_embedding"] = (batch["i_targets"], batch["i_seg"], batch["i_valid"])
        tbl_norm_sq = sparse_table_updates(
            tables,
            state.table_state,
            row_grads,
            lr=lr,
            step=step_num,
            pre=pre or None,
        )
        if clock is not None:
            clock.add_(1.0)
        dense_sq = sum(torch.sum(g * g) for g in dense_grads)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["grad_norm"] = torch.sqrt(dense_sq + tbl_norm_sq)
        new_state = TrainState(
            step=state.step + 1,
            params=state.params,
            opt_state=new_opt,
            table_state=state.table_state,
        )
        return new_state, metrics

    return step

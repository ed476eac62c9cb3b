"""Explicit-collective lookups into row-sharded embedding tables, and the
distributed row update (the "gradient scatter").

Counterpart of ``twotower_tpu/parallel/a2a.py``, on ``torch.distributed``:

- ``psum_lookup``: each rank gathers the ids it owns (the others masked to
  zero) and the partial rows are summed over the axis (``all_reduce``).
- ``alltoall_lookup``: ids are bucketed by owner (sort, duplicate ids
  deduplicated into one slot, a static capacity a destination, overflow
  into a trash bucket), exchanged with ``all_to_all_single``, gathered on
  the owner and returned with a second exchange. The buckets are padded to
  the static capacity as JAX pads them, so every exchange has equal splits
  and fixed shapes (a CUDA graph can capture it).
- ``alltoall_row_update``: the lookup's transpose for the sparse train
  step: row gradients routed to their owners, deduplicated there (sort +
  segment sum) and applied by the packed lazy-Adam row update.

Where JAX gets a lookup's backward from ``jax.grad`` through the exchange,
each lookup here is a ``torch.autograd.Function`` whose backward is the
reverse exchange plus the segment scatter-add. A lookup's gradient is that
of the sum of every rank's loss (each rank's cotangent is its own);
``sharded_embedding_lookup`` is the replicated form, whose one loss every
rank computes (the cotangent is then divided by the axis size, as JAX's
``shard_map`` transposes a replicated output).

Row layout: global id ``g`` lives on axis index ``g // rows_per_shard`` at
local row ``g % rows_per_shard``.
"""

from __future__ import annotations

import torch

from twotower_tpu_torch.parallel.mesh import Axis


def _bucket_by_owner(ids: torch.Tensor, rows_per_shard: int, num_shards: int, cap: int):
    """Group-by-owner into ``[num_shards + 1, cap]`` buckets with duplicate ids
    sharing one slot (JAX ``_bucket_by_owner``): ``(sorted_ids,
    sorted_owner, dest, slot, order, bucket_pos, dropped)``. Bucket
    ``num_shards`` is the trash row of the entries past capacity;
    ``bucket_pos`` is each sorted entry's unique-id position in its owner's
    bucket (before the clamp) and ``dropped`` counts the entries past
    capacity (int32, on the device)."""
    b = ids.shape[0]
    dev = ids.device
    ids = ids.long()
    owner = torch.clamp(torch.div(ids, rows_per_shard, rounding_mode="floor"), 0,
                        num_shards - 1)
    order = torch.argsort(ids, stable=True)  # owner-monotonic, duplicates adjacent
    sorted_ids = ids[order]
    sorted_owner = owner[order]
    first = torch.ones(b, dtype=torch.bool, device=dev)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    urank = torch.cumsum(first, 0) - 1  # unique rank; duplicates share it
    starts = torch.searchsorted(sorted_owner, torch.arange(num_shards, device=dev))
    start_urank = urank[torch.clamp(starts, 0, b - 1)]
    bucket_pos = urank - start_urank[sorted_owner]
    overflow = bucket_pos >= cap
    dest = torch.where(overflow, num_shards, sorted_owner)
    slot = torch.clamp(bucket_pos, max=cap - 1)
    dropped = overflow.sum(dtype=torch.int32)
    return sorted_ids, sorted_owner, dest, slot, order, bucket_pos, dropped


class _AllToAllLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids, axis: Axis, cap: int):
        rps = table_shard.shape[0]
        s, me = axis.size, axis.index
        sorted_ids, sorted_owner, dest, slot, order, bucket_pos, dropped = _bucket_by_owner(
            ids, rps, s, cap)
        # Send buffer [S+1, cap]: row j holds the ids bound for index j; the
        # padding points at row 0 of j's shard (in bounds on the owner).
        send = (torch.arange(s + 1, device=ids.device) * rps)[:, None].repeat(1, cap)
        send[dest, slot] = sorted_ids
        recv = axis.all_to_all(send[:s].reshape(-1))  # the ids each index wants from me
        local = torch.clamp(recv - me * rps, 0, rps - 1)
        resp = axis.all_to_all(table_shard[local])  # the rows of the ids I sent
        pick = sorted_owner * cap + torch.clamp(bucket_pos, max=cap - 1)
        out = torch.empty((ids.shape[0], table_shard.shape[1]), dtype=table_shard.dtype,
                          device=table_shard.device)
        out[order] = resp[pick]
        ctx.save_for_backward(order, pick, local)
        ctx.axis, ctx.rps = axis, rps
        ctx.mark_non_differentiable(dropped)
        return out, dropped

    @staticmethod
    def backward(ctx, g, _g_dropped):
        order, pick, local = ctx.saved_tensors
        g_resp = g.new_zeros((local.shape[0], g.shape[1])).index_add_(0, pick, g[order])
        g_rows = ctx.axis.all_to_all(g_resp)  # back to the owners
        g_table = g.new_zeros((ctx.rps, g.shape[1])).index_add_(0, local, g_rows)
        return g_table, None, None, None


def alltoall_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    axis: Axis,
    *,
    capacity: int | None = None,
    return_stats: bool = False,
):
    """Rows ``[B, E]`` of ``ids`` (global row ids, this rank's own) from the
    table row-sharded over ``axis``: each id is sent to its owner and its
    row comes back. ``capacity`` is the bucket size a destination (default
    ``B``, which never drops). Ids past a bucket's capacity get arbitrary
    rows and do not corrupt the others; ``return_stats`` also returns
    their count (an int32 tensor)."""
    b = ids.shape[0]
    cap = b if capacity is None else min(capacity, b)
    out, dropped = _AllToAllLookup.apply(table_shard, ids, axis, cap)
    return (out, dropped) if return_stats else out


class _PsumLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table_shard, ids, axis: Axis):
        rps = table_shard.shape[0]
        local = ids.long() - axis.index * rps
        owned = (local >= 0) & (local < rps)
        local = torch.clamp(local, 0, rps - 1)
        rows = torch.where(owned[:, None], table_shard[local], 0.0)
        ctx.save_for_backward(local, owned)
        ctx.axis, ctx.rps = axis, rps
        return axis.all_reduce(rows)

    @staticmethod
    def backward(ctx, g):
        local, owned = ctx.saved_tensors
        g = ctx.axis.all_reduce(g)  # every rank's rows summed this rank's
        g_table = g.new_zeros((ctx.rps, g.shape[1])).index_add_(
            0, local, torch.where(owned[:, None], g, 0.0))
        return g_table, None, None


def psum_lookup(table_shard: torch.Tensor, ids: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Rows ``[B, E]`` of ``ids`` (the same ids on every rank of ``axis``):
    a masked local gather and an all-reduce over the axis."""
    return _PsumLookup.apply(table_shard, ids, axis)


@torch.no_grad()
def alltoall_row_update(
    table_shard: torch.Tensor,
    moments_shard: torch.Tensor,
    ids: torch.Tensor,
    grads: torch.Tensor,
    axis: Axis,
    *,
    capacity: int | None = None,
    lr,
    step,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed gradient scatter (JAX ``alltoall_row_update``): route
    each ``(id, row gradient)`` of this rank to the id's owner over
    ``axis`` (duplicates pre-combined in their shared slot), deduplicate at
    the owner (sort + segment sum, which also sums the contributions of
    different ranks) and apply the packed lazy-Adam row update to the local
    shard, in place. Returns ``(grad_norm_sq, dropped)``: this shard's share
    of the table gradient's squared norm (sum it over the axis) and the
    entries past capacity (int32 tensors on the device). ``lr`` and
    ``step`` are numbers or 0-d device tensors, as in
    ``training.sparse.adam_row_update_packed``."""
    from twotower_tpu_torch.training.sparse import adam_row_update_packed, dedup_rows

    rps = table_shard.shape[0]
    s, me = axis.size, axis.index
    r, e = grads.shape
    cap = r if capacity is None else min(capacity, r)
    sorted_ids, _, dest, slot, order, _, dropped = _bucket_by_owner(ids, rps, s, cap)
    send_ids = torch.full((s + 1, cap), -1, dtype=torch.long, device=ids.device)
    send_ids[dest, slot] = sorted_ids
    # Accumulate: duplicate ids share a slot, so their gradients combine
    # before the exchange and the owner only merges across ranks.
    send_grads = grads.new_zeros((s + 1, cap, e), dtype=torch.float32)
    send_grads.index_put_((dest, slot), grads[order].float(), accumulate=True)
    recv_ids = axis.all_to_all(send_ids[:s].reshape(-1))
    recv_grads = axis.all_to_all(send_grads[:s].reshape(s * cap, e))
    # Owner-side dedup; invalid entries (padding, id -1) sort last under the
    # sentinel row ``rps`` and are masked out.
    valid_in = recv_ids >= 0
    local = torch.where(valid_in, torch.clamp(recv_ids - me * rps, 0, rps - 1), rps)
    g_in = recv_grads * valid_in[:, None].float()
    targets, summed, valid = dedup_rows(local, g_in, 0)
    valid = valid & (targets < rps)
    targets = torch.where(valid, targets, 0)
    adam_row_update_packed(table_shard, moments_shard, targets, summed, valid, lr=lr,
                           b1=b1, b2=b2, eps=eps, step=step)
    norm_sq = torch.sum(summed * summed * valid.float()[:, None])
    return norm_sq, dropped


class _Replicated(torch.autograd.Function):
    """Identity whose backward divides by the axis size: the cotangent of an
    output every rank holds whole and reduces to one loss."""

    @staticmethod
    def forward(ctx, x, size: int):
        ctx.size = size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None


def sharded_embedding_lookup(
    table_shard: torch.Tensor,
    ids: torch.Tensor,
    axis: Axis,
    *,
    strategy: str = "alltoall",
) -> torch.Tensor:
    """A lookup with the same ids on every rank and the whole result on every
    rank (the JAX wrapper's ``P(model, None)`` table, replicated ids and
    output), through either strategy; its gradient is that of one loss
    computed alike on every rank."""
    fn = {"alltoall": alltoall_lookup, "psum": psum_lookup}[strategy]
    return _Replicated.apply(fn(table_shard, ids, axis), axis.size)

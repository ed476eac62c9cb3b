"""Host-side id dedup for the sparse train step (input-pipeline precompute).

The PyTorch port's own copy of ``twotower_tpu/training/host_dedup.py``
(numpy only; the batch contract below is shared by both packages). The
timings quoted below were taken on a TPU v5e and say nothing about a GPU.

The single-device sparse step's in-device dedup (``training/sparse.py::
dedup_rows`` — argsort + segment ops) costs ~0.21 ms of the 2.42 ms step at
batch 4096 (round-4 ablation: full step 2.421 ms vs 2.207 ms with dedup
removed). The TPU has ONE tensor core, so those serial sort/segment ops
cannot overlap the matmuls — but they depend only on the batch's *ids*,
which the host already holds. This module moves the dedup into the input
pipeline: ``np.unique`` per batch (~0.2 ms host time, hidden behind the
existing ``DevicePrefetcher`` overlap), shipped as three small int/bool
arrays per table, leaving the device only the grads segment-sum (one
[B, E] scatter-add it needs in any formulation).

Measured (v5e, batch 4096, 1M x 500k tables, slope-timed): 2.416 ms
(device dedup) -> 2.242 ms (host dedup), −7.2%. Numerically equivalent:
targets/valid identical, summed grads equal up to f32 summation order
(grad_norm matches to ~3e-7 relative).

Scope: the host can only precompute ids it knows. That is the batch's
``user_idx`` always, and ``item_idx`` when candidate sampling is
``in_batch`` (uniform/mixed sampling concatenates device-generated negative
ids — those tables keep the in-device dedup, as does the text-token table
and the sharded mesh path, whose dedup happens at the owner shard after the
all-to-all).

Batch contract: ``augment_batch`` adds, per table, ``{u,i}_targets``
(int32 [B]: unique ids front-packed, dead-row padded), ``{u,i}_seg``
(int32 [B]: row -> segment, order-preserving), ``{u,i}_valid``
(bool [B]). ``make_sparse_step_fn`` picks them up when present; batches
without the keys compile to the in-device dedup program (different pytree
structure => separate jit cache entry, no retrace churn).
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np

Batch = dict[str, Any]

# Batch-key suffixes for one precomputed table dedup.
KEYS = ("targets", "seg", "valid")


def dedup_host(ids: np.ndarray, dead: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """np.unique-based dedup precompute for one id column.

    Returns ``(targets, seg, valid)``: ``targets[k]`` = k-th unique id
    (sorted ascending, matching the device ``dedup_rows`` segment order) or
    ``dead`` for empty segments; ``seg[j]`` = segment of batch row ``j``;
    ``valid[k]`` = segment ``k`` is real.
    """
    b = ids.shape[0]
    uniq, inv = np.unique(ids, return_inverse=True)
    targets = np.full(b, dead, np.int32)
    targets[: uniq.shape[0]] = uniq
    valid = np.zeros(b, bool)
    valid[: uniq.shape[0]] = True
    return targets, inv.astype(np.int32), valid


def augment_batch(batch: Batch, *, user_dead: int, item_dead: int | None) -> Batch:
    """Attach per-table dedup keys to one host batch (in place-ish copy).

    ``item_dead=None`` skips the item table (uniform/mixed sampling — the
    device concatenates sampled negative ids the host never sees).
    """
    out = dict(batch)
    t, s, v = dedup_host(np.asarray(batch["user_idx"]), user_dead)
    out["u_targets"], out["u_seg"], out["u_valid"] = t, s, v
    if item_dead is not None:
        t, s, v = dedup_host(np.asarray(batch["item_idx"]), item_dead)
        out["i_targets"], out["i_seg"], out["i_valid"] = t, s, v
    return out


def augment_epoch(
    epoch: Iterator[Batch], *, user_dead: int, item_dead: int | None
) -> Iterator[Batch]:
    """Wrap an epoch's batch iterator with the dedup precompute. Runs on the
    pipeline thread side of ``DevicePrefetcher``, so the ~0.2 ms/batch host
    cost overlaps device execution like the rest of input prep."""
    for batch in epoch:
        yield augment_batch(batch, user_dead=user_dead, item_dead=item_dead)


def wants_host_dedup(config, mesh) -> bool:
    """Host dedup applies to the single-device sparse step only: the mesh
    path dedups at the owner shard after the all-to-all exchange."""
    return (
        mesh is None
        and config.training.effective_sparse_updates()
        and config.training.host_dedup
    )

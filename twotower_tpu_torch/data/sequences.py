"""Users' interaction histories for the sequence user tower
(``model.user_tower: sequence``, ``models/seq_tower.py``).

Training (``StreamDataset``): each user's train interactions in time order
become slots, slot ``t`` reading item ``t`` with item ``t + 1`` as its
target (a user of ``n`` interactions gives ``n - 1`` slots); a user's slots
are cut into windows of at most ``max_window``. The windows are shuffled
once, by the seed, and packed end to end into streams of ``stream`` slots:
a window that does not fit at a stream's end is cut there and goes on at
the next stream's start as a window of its own (its positions restart, so
attention never crosses a stream). The last stream is padded with slots of
weight 0, each a window of one. The device loop permutes whole streams each
epoch.

Evaluation (``UserHistories``): a user's state is read after their last
``max_window`` train interactions; every evaluated row lies after the train
split in time, so that is the user's last ``max_window`` interactions
before the row. A user without train interactions reads one slot of the
item table's spare row (``two_tower.dead_row``), which no id ever trains.

Both take the train split's rows in time order (``PreparedDataset.
load_splits`` sorts them so) and keep each user's rows in that order.
"""

from __future__ import annotations

import numpy as np
import torch

from twotower_tpu_torch.utils.platform import resolve_device


def user_slots(user_idx, item_idx, max_window: int):
    """Every user's slots in time order, users one after another:
    ``(hist, target, pos)`` int arrays, ``pos`` the slot's place in its
    window of at most ``max_window``."""
    user = np.asarray(user_idx, np.int64)
    item = np.asarray(item_idx, np.int64)
    order = np.argsort(user, kind="stable")
    user, item = user[order], item[order]
    if len(user) < 2:
        empty = np.empty(0, np.int64)
        return empty, empty, empty
    slot = np.nonzero(user[1:] == user[:-1])[0]
    first = np.ones(len(user), bool)
    first[1:] = user[1:] != user[:-1]
    start = np.maximum.accumulate(np.where(first, np.arange(len(user)), 0))
    return item[slot], item[slot + 1], (slot - start[slot]) % max_window


def pack_streams(hist, target, pos, stream: int, seed: int) -> dict[str, np.ndarray]:
    """The windows (``pos == 0`` starts one) shuffled by ``seed`` and packed
    into streams of ``stream`` slots: ``{"hist_idx", "item_idx", "pos",
    "weight"}``, each a multiple of ``stream`` long."""
    hist, target, pos = (np.asarray(a, np.int64) for a in (hist, target, pos))
    n = len(hist)
    if n:
        starts = np.nonzero(pos == 0)[0]
        lengths = np.diff(np.append(starts, n))
        perm = np.random.default_rng(seed).permutation(len(starts))
        lengths = lengths[perm]
        before = np.cumsum(lengths) - lengths
        idx = np.repeat(starts[perm] - before, lengths) + np.arange(n)
        hist, target = hist[idx], target[idx]
        window = np.repeat(np.arange(len(starts)), lengths)
        i = np.arange(n)
        boundary = (i % stream == 0)
        boundary[1:] |= window[1:] != window[:-1]
        pos = i - np.maximum.accumulate(np.where(boundary, i, 0))
    total = max(1, -(-n // stream)) * stream
    pad = total - n
    weight = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    zeros = np.zeros(pad, np.int64)
    return {"hist_idx": np.concatenate([hist, zeros]).astype(np.int32),
            "item_idx": np.concatenate([target, zeros]).astype(np.int32),
            "pos": np.concatenate([pos, zeros]).astype(np.int32),
            "weight": weight}


class StreamDataset:
    """The train split as packed streams on the device: the device loop's
    dataset for a sequence tower (``DeviceTrainer.fit`` reads ``columns``,
    ``num_steps`` and ``num_examples``: the slots with a target)."""

    def __init__(self, user_idx, item_idx, config, *, device=None):
        s = config.model.sequence
        self.batch_size = config.training.batch_size
        if self.batch_size % s.max_window:
            raise ValueError(f"training.batch_size={self.batch_size} (the stream) must be a "
                             f"multiple of model.sequence.max_window={s.max_window}")
        hist, target, pos = user_slots(user_idx, item_idx, s.max_window)
        if not len(hist):
            raise ValueError("no user has two train interactions: no slot to train on")
        cols = pack_streams(hist, target, pos, self.batch_size, config.training.seed)
        self.num_examples = len(hist)
        self.num_steps = len(cols["weight"]) // self.batch_size
        dev = resolve_device(device)
        self.columns = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}


class UserHistories:
    """Each user's last ``max_window`` train items, on the device:
    ``windows(users)`` gives ``([B, max_window] item ids, left-aligned and
    padded with the spare row, [B] lengths in [1, max_window])``."""

    def __init__(self, user_idx, item_idx, num_users: int, max_window: int, pad_item: int,
                 *, device=None):
        user = np.asarray(user_idx, np.int64)
        order = np.argsort(user, kind="stable")
        dev = resolve_device(device)
        self.max_window = max_window
        self.pad_item = int(pad_item)
        self.items = torch.from_numpy(np.asarray(item_idx, np.int64)[order]).to(dev)
        counts = np.bincount(user, minlength=num_users)
        self.ends = torch.from_numpy(np.cumsum(counts)).to(dev)
        self.counts = torch.from_numpy(counts).to(dev)

    def windows(self, users: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        users = users.to(self.items.device).long()
        n = torch.clamp(self.counts[users], max=self.max_window)
        slot = torch.arange(self.max_window, device=users.device)
        at = (self.ends[users] - n)[:, None] + slot[None, :]
        real = slot[None, :] < n[:, None]
        pad = torch.full_like(at, self.pad_item)
        if len(self.items):
            taken = self.items[at.clamp(0, len(self.items) - 1)]
            windows = torch.where(real, taken, pad)
        else:
            windows = pad
        return windows, torch.clamp(n, min=1)

"""A run with the timed path broken underneath must come out not correct.
Each test drives a whole run of a cell (set-up, window, check; no look for
a card) at a tiny size on the CPU with one fault planted in the program, and
the committed limits: a step that returns its state unchanged; half of the
batch left out, the mean taken over the rest; an answer altered where it is
produced; and, for training, faults that reach only the steps the window
replays after an epoch end (the step clock reset, the state left unchanged). (Every cell runs on one chip: there is no exchange between chips
to leave out.) ``PLANTS`` also serves the readings of the same faults at a
cell's own size on the card."""

import numpy as np
import pytest
import torch

from perfbench.harness.manifest import load_cell
from perfbench.harness.runner import run_cell
from perfbench.tests.tiny import tiny_root


def state_unchanged(mp):
    from dataclasses import replace

    from twotower_tpu_torch.training import sparse, state

    def no_update(tables, table_state, row_grads, **kw):
        return torch.zeros((), device=next(iter(tables.values())).device)

    mp.setattr(sparse, "sparse_table_updates", no_update)
    mp.setattr(state.Adam, "update_", lambda self, p, g, st, **kw: replace(st, count=st.count + 1))


def train_half_batch(mp):
    from twotower_tpu_torch.ops import dispatch

    inner = dispatch.in_batch_softmax_loss_auto

    def loss(u, v, ids, *, weights=None, **kw):
        h = u.shape[0] // 2
        return inner(u[:h], v[:h], ids[:h], weights=None if weights is None else weights[:h], **kw)

    mp.setattr(dispatch, "in_batch_softmax_loss_auto", loss)


def train_loss_altered(mp):
    from twotower_tpu_torch.ops import dispatch

    inner = dispatch.in_batch_softmax_loss_auto

    def altered(*args, **kw):
        loss, metrics = inner(*args, **kw)
        return loss * (1.0 + 1e-3), metrics

    mp.setattr(dispatch, "in_batch_softmax_loss_auto", altered)


def _after_epoch_0(mp, change):
    """``change(program, state)`` at every epoch's start from epoch 1 on:
    the steps the window replays after an epoch end, and not set-up's."""
    from twotower_tpu_torch.training import device_loop

    inner = device_loop._EpochProgram.begin_epoch

    def begin(self, state, columns, epoch, *args, **kw):
        inner(self, state, columns, epoch, *args, **kw)
        if epoch >= 1:
            change(self, state)

    mp.setattr(device_loop._EpochProgram, "begin_epoch", begin)


def clock_reset_at_epoch_end(mp):
    """The step clock (Adam's bias corrections) starts again at 0 after an
    epoch end."""
    _after_epoch_0(mp, lambda prog, state: prog._clock.fill_(0.0))


def replays_unchanged_after_epoch_0(mp):
    """The steps after the first epoch end leave the state as it was."""
    def freeze(prog, state):
        prog._body = lambda *a, **kw: prog._row.add_(1)

    _after_epoch_0(mp, freeze)


def eval_half_batch(mp):
    from twotower_tpu_torch.evaluation import evaluator

    inner = evaluator.metrics_at_k

    def half(topk_idx, true_item, ks, **kw):
        h = max(1, topk_idx.shape[0] // 2)
        return inner(topk_idx[:h], true_item[:h], ks, **kw)

    mp.setattr(evaluator, "metrics_at_k", half)


def eval_answer_altered(mp):
    from twotower_tpu_torch.evaluation import evaluator

    for search in ("topk_mips_approx", "topk_mips_twopass"):
        def altered(query, corpus, k, _inner=getattr(evaluator, search), **kw):
            vals, ids = _inner(query, corpus, k, **kw)
            ids = ids.clone()
            ids[:, 0] = (ids[:, 0] + corpus.shape[0] // 2) % corpus.shape[0]
            return vals, ids

        mp.setattr(evaluator, search, altered)


def serve_half_batch(mp):
    from twotower_tpu_torch.serving.index import RetrievalIndex

    inner = RetrievalIndex.recommend

    def half(self, user_idx, k=100):
        user_idx = np.atleast_1d(np.asarray(user_idx))
        h = max(1, len(user_idx) // 2)
        scores, items = inner(self, user_idx[:h], k)
        reps = -(-len(user_idx) // h)
        return (np.tile(scores, (reps, 1))[:len(user_idx)],
                np.tile(items, (reps, 1))[:len(user_idx)])

    mp.setattr(RetrievalIndex, "recommend", half)


def serve_answer_altered(mp):
    from twotower_tpu_torch.serving.index import RetrievalIndex

    inner = RetrievalIndex.recommend

    def altered(self, user_idx, k=100):
        scores, items = inner(self, user_idx, k)
        items = items.copy()
        items[:, -1] = (items[:, -1] + self.num_items // 2) % self.num_items
        return scores, items

    mp.setattr(RetrievalIndex, "recommend", altered)


PLANTS = {
    "c3_train": [state_unchanged, train_half_batch, train_loss_altered, clock_reset_at_epoch_end,
                 replays_unchanged_after_epoch_0],
    "c3_validate": [eval_half_batch, eval_answer_altered],
    "c3_eval_exact": [eval_half_batch, eval_answer_altered],
    "c4_serve": [serve_half_batch, serve_answer_altered],
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny_faults"))


@pytest.mark.parametrize("workload, plant", [(w, p) for w, ps in PLANTS.items() for p in ps],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_planted_fault_is_not_correct(root, monkeypatch, workload, plant):
    plant(monkeypatch)
    line = run_cell(load_cell(root, workload), 2**31 + 5, 0.3, False, "cpu", log=lambda m: None)
    assert not line["correct"], line["compared"]

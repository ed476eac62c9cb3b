"""The sequence user tower (``models/seq_tower.py``, ``training/seq_step.py``)
against the plain reference (``reference/seq_tower.py``) on the CPU at a
small size: hidden 64, 4 heads of 16 + 8 (query/key) and 16 (value) over a
32-wide latent, 8 routed experts of 32 (top 2) and 1 shared, one dense layer
of 96 and two MoE layers, 500 items at width 16, an item tower [32, 16],
96-slot streams of windows of at most 16.

Tolerances, with their reasons:

- ``F32``: the float32 tower against the float32 reference, which computes
  the same sums in another order (dense masks and whole-sequence attention
  against blocks of 16 keys, one expert at a time against grouped products,
  ``index_add`` of each expert's share against a sum over the slot's
  experts): a few float32 ulps of each output, relative 1e-5 leaves room
  for their growth over three layers.
- ``STEP``: gradients and the weights after three Adam steps, relative to
  each leaf's norm: the gradients sum over 96 slots in another order, and
  Adam's update, ``m / (sqrt(v) + eps)``, magnifies relative differences of
  elements whose gradient is tiny; 1e-3 of the change's norm.
- The bfloat16 tower differs from the float32 reference by its rounding
  (8 mantissa bits: about 4e-3 of each operand), far above ``F32``; the
  test checks that it fails ``F32`` and stays within 5e-2.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data.sequences import pack_streams, user_slots
from twotower_tpu_torch.models import seq_tower, two_tower
from twotower_tpu_torch.reference import seq_tower as ref
from twotower_tpu_torch.training.loop import make_raw_step
from twotower_tpu_torch.training.state import TrainState, make_optimizer, tree_leaves

F32 = 1e-5
STEP = 1e-3
NUM_ITEMS = 500
STREAM = 96
SEQ = {"hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1,
       "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
       "num_experts_per_tok": 2, "n_shared_experts": 1, "num_attention_heads": 4,
       "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
       "max_window": 16}


def config(dtype: str = "float32", **seq) -> Config:
    return Config.from_dict({
        "model": {"embedding_dim": 16, "user_tower_dims": [32, 16], "item_tower_dims": [32, 16],
                  "compute_dtype": dtype, "user_tower": "sequence", "dropout_rate": 0.1,
                  "sequence": {**SEQ, **seq}},
        "training": {"batch_size": STREAM, "seed": 3},
    })


def ref_cfg(cfg: Config) -> dict:
    m = cfg.model
    return dict(dataclasses.asdict(m.sequence), embedding_dim=m.embedding_dim,
                temperature=cfg.retrieval.temperature, l2=m.l2_regularization,
                dropout=m.dropout_rate)


def params_for(cfg: Config, seed: int = 0) -> dict:
    return two_tower.init_params(torch.Generator().manual_seed(seed), cfg.model, 1, NUM_ITEMS)


def streams(seed: int = 0, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    users, items = rng.integers(0, 60, n), rng.integers(0, NUM_ITEMS, n)
    cols = pack_streams(*user_slots(users, items, SEQ["max_window"]), STREAM, seed)
    return {k: torch.from_numpy(v) for k, v in cols.items()}


def batch_of(cols: dict, i: int) -> dict:
    return {k: v[i * STREAM:(i + 1) * STREAM] for k, v in cols.items()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp(min=1e-30))


def port_forward(params, batch, cfg):
    rows = params["item_embedding"][batch["hist_idx"].long()]
    h, aux, counts = seq_tower.forward_stream(params, rows, batch["pos"], batch["weight"],
                                              cfg.model)
    return seq_tower.head(params, h, cfg.model), aux, counts


def ref_forward(params, batch, cfg):
    rows = params["item_embedding"][batch["hist_idx"].long()]
    u, aux, windows, routes = ref.tower(params, rows, batch["pos"], batch["weight"].float(),
                                        ref_cfg(cfg))
    return u, aux / windows, routes


def test_forward_matches_the_reference():
    cfg = config()
    params, b = params_for(cfg), batch_of(streams(), 0)
    u, aux, counts = port_forward(params, b, cfg)
    u_ref, aux_ref, routes = ref_forward(params, b, cfg)
    assert rel(u, u_ref) < F32
    assert float(aux) == pytest.approx(float(aux_ref), rel=F32)
    for layer_counts, experts in zip(counts, routes):  # the routed slots per expert
        assert torch.equal(layer_counts, torch.bincount(experts.flatten(), minlength=8).float())


def test_bfloat16_fails_the_float32_tolerance():
    cfg16, cfg32 = config("bfloat16"), config()
    params, b = params_for(cfg32), batch_of(streams(), 0)
    u16, _, _ = port_forward(params, b, cfg16)
    u_ref, _, _ = ref_forward(params, b, cfg32)
    assert F32 < rel(u16, u_ref) < 5e-2


def test_balance_loss_matches_the_reference():
    torch.manual_seed(0)
    b = batch_of(streams(1), 1)
    t, n, k = STREAM, 8, 2
    scores = torch.softmax(torch.randn(t, n) * 2.0, dim=-1)
    experts = torch.topk(scores, k, dim=-1).indices
    weight = b["weight"].clone()
    weight[-5:] = 0.0  # padding slots count in no window
    window = torch.cumsum((b["pos"] == 0).long(), 0) - 1
    loss, counts = seq_tower.balance_loss(scores, experts, weight, window, 0.001)
    total, windows = ref.balance(scores, experts, weight, b["pos"], ref_cfg(config()))
    assert float(loss) == pytest.approx(float(total / windows), rel=1e-6)
    assert torch.equal(counts, torch.bincount(experts[:-5].flatten(), minlength=n).float())
    # Even routing reads alpha: f_i = 1 and P_i = 1 / N for every expert.
    even = torch.full((t, n), 1.0 / n)
    spread = (torch.arange(t)[:, None] * k + torch.arange(k)[None, :]) % n
    loss_even, _ = seq_tower.balance_loss(even, spread, torch.ones(t), torch.arange(t) // 8,
                                          0.001)
    assert float(loss_even) == pytest.approx(0.001, rel=1e-6)


def test_a_packed_stream_equals_each_window_alone():
    """Masks and RoPE restart: each window's outputs in the stream are its
    outputs run alone (padded to ``max_window`` with weight-0 slots)."""
    cfg = config()
    params, b = params_for(cfg), batch_of(streams(2), 0)
    u, _, _ = port_forward(params, b, cfg)
    starts = torch.nonzero(b["pos"] == 0).flatten().tolist() + [STREAM]
    assert len(starts) > 4
    w = SEQ["max_window"]
    for lo, hi in zip(starts[:-1], starts[1:]):
        ids = torch.zeros(w, dtype=torch.long)
        ids[:hi - lo] = b["hist_idx"][lo:hi].long()
        alone = {"hist_idx": ids, "pos": torch.arange(w),
                 "weight": (torch.arange(w) < hi - lo).float()}
        u_alone, _, _ = port_forward(params, alone, cfg)
        assert rel(u[lo:hi], u_alone[:hi - lo]) < F32


def test_dropless_routing_under_a_forced_imbalance():
    """Every slot routed to experts 0 and 1: none is dropped, the buffer
    holds each (slot, expert) pair once, and the result is each slot's own
    two experts' gated sum."""
    torch.manual_seed(1)
    t, h, f, n = 40, 16, 8, 4
    p = {"gate_up": torch.randn(n, 2 * f, h), "down": torch.randn(n, h, f)}
    x = torch.randn(t, h)
    experts = torch.tensor([[0, 1]] * t)
    gates = torch.rand(t, 2)
    order, dest, src, ends = seq_tower.dispatch(experts, n)
    assert sorted(src[dest].tolist()) == sorted(list(range(t)) * 2)  # every pair has its row
    assert int((src < t).sum()) == 2 * t  # the rest are padding
    assert ends.tolist() == [48, 96, 96, seq_tower.capacity(2 * t, n)]  # groups of 16
    out = seq_tower.routed_experts(p, x, gates, experts, n, torch.float32)
    want = torch.zeros(t, h)
    for e in (0, 1):
        g, u = (x @ p["gate_up"][e].T).chunk(2, dim=-1)
        want += gates[:, e:e + 1] * ((torch.nn.functional.silu(g) * u) @ p["down"][e].T)
    assert rel(out, want) < F32


def _state(cfg, params):
    return TrainState.for_config(params, make_optimizer(cfg.training), cfg)


def _ref_step_state(params, ids):
    leaves = ref.dense_leaves(params)
    e = params["item_embedding"][1].shape[1]
    return {"mu": [torch.zeros_like(t) for t in leaves],
            "nu": [torch.zeros_like(t) for t in leaves],
            "rows_mu": torch.zeros(len(ids), e), "rows_nu": torch.zeros(len(ids), e)}


def _masks(seed: int, steps: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [[torch.rand((STREAM, 32), generator=gen) < 0.9] for _ in range(steps)]


def test_three_steps_match_the_reference():
    """The port's step from the same weights and the reference's: the first
    step's gradient of every leaf and of the item rows, the losses, and the
    weights after three steps."""
    cfg = config()
    params = params_for(cfg, 5)
    cols = streams(3)
    batches = [batch_of(cols, i) for i in range(3)]
    log_q = torch.log(torch.rand(NUM_ITEMS) * 0.01 + 1e-4)
    ids = torch.unique(torch.cat([torch.cat([b["hist_idx"], b["item_idx"]]) for b in batches])
                       .long())
    mine = params_for(cfg, 5)
    theirs = {k: v for k, v in params_for(cfg, 5).items() if k != "item_embedding"}
    theirs["item_embedding"] = (ids, params["item_embedding"][ids].clone())
    state = _state(cfg, mine)
    step = make_raw_step(cfg, make_optimizer(cfg.training), num_items=NUM_ITEMS)
    rng = torch.Generator().manual_seed(cfg.training.seed + 1)
    ref_state = _ref_step_state(theirs, ids)
    masks = _masks(cfg.training.seed + 1, 3)
    rc = ref_cfg(cfg)
    for t, b in enumerate(batches, start=1):
        state, metrics = step(state, b, rng, log_q)
        loss, g_dense, g_rows, _ = ref.step(theirs, ref_state, b, log_q, rc, masks[t - 1], t,
                                            cfg.training.learning_rate)
        assert float(metrics["loss"]) == pytest.approx(loss, rel=F32)
        if t == 1:
            mu = tree_leaves({k: state.opt_state.mu[k] for k in ("item_tower", "seq_tower")})
            assert len(mu) == len(g_dense) == 40  # item tower 4, tower 36
            for m, g in zip(mu, g_dense):
                assert rel(m / 0.1, g) < STEP
            first = torch.unique(torch.cat([b["hist_idx"], b["item_idx"]]).long())
            moments = state.table_state["item_embedding"]["moments"][first, :16]
            assert rel(moments / 0.1, g_rows[torch.searchsorted(ids, first)]) < STEP
    start = params_for(cfg, 5)
    for (a, b0), r in zip(zip(tree_leaves({k: state.params[k] for k in ("item_tower",
                                                                          "seq_tower")}),
                              tree_leaves({k: start[k] for k in ("item_tower", "seq_tower")})),
                          ref.dense_leaves(theirs)):
        assert rel(a - b0, r - b0) < STEP
    rows = state.params["item_embedding"][ids]
    assert rel(rows - start["item_embedding"][ids], theirs["item_embedding"][1]
               - start["item_embedding"][ids]) < STEP


def test_the_step_fails_the_float32_tolerance_in_bfloat16():
    cfg16, cfg32 = config("bfloat16"), config()
    b = batch_of(streams(4), 0)
    log_q = torch.full((NUM_ITEMS,), -6.0)
    losses = []
    for cfg in (cfg16, cfg32):
        state = _state(cfg, params_for(cfg, 7))
        step = make_raw_step(cfg, make_optimizer(cfg.training), num_items=NUM_ITEMS)
        _, metrics = step(state, b, torch.Generator().manual_seed(1), log_q)
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) / losses[1] > F32

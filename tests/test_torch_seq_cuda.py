"""The sequence user tower on the card (marked ``cuda``; skipped without
one): the device loop's epoch with the step captured as a CUDA graph equals
the same epoch run eagerly, at a small size in bfloat16 (grouped GEMMs,
recomputation, the fused loss), with the timed capture's phases and the
routed-slot counter. This file imports no JAX."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data.sequences import StreamDataset
from twotower_tpu_torch.training.device_loop import make_epoch_fn
from twotower_tpu_torch.training.state import init_train_state, make_optimizer, tree_leaves
from twotower_tpu_torch.utils import profiling

SEQ = {"hidden_size": 128, "num_hidden_layers": 3, "first_k_dense_replace": 1,
       "intermediate_size": 192, "moe_intermediate_size": 64, "n_routed_experts": 8,
       "num_experts_per_tok": 2, "n_shared_experts": 1, "num_attention_heads": 4,
       "kv_lora_rank": 64, "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32,
       "max_window": 16}


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_captured_epoch_equals_eager(cuda_device):
    cfg = Config.from_dict({
        "model": {"embedding_dim": 32, "user_tower_dims": [64, 32], "item_tower_dims": [64, 32],
                  "user_tower": "sequence", "dropout_rate": 0.0, "sequence": SEQ},
        "training": {"batch_size": 256, "seed": 5}})
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 100, 6000), rng.integers(0, 700, 6000)
    data = StreamDataset(users, items, cfg, device=cuda_device)
    log_q = torch.full((700,), -6.5, device=cuda_device)
    out = []
    for capture in (False, True):
        opt = make_optimizer(cfg.training)
        state = init_train_state(cfg, opt, 100, 700, device=cuda_device)
        prog = make_epoch_fn(cfg, opt, data.num_steps, num_items=700, device=cuda_device,
                             capture=capture)
        state, metrics = prog(state, data.columns, 0, log_q)
        out.append((state, {k: float(v) for k, v in metrics.items()}, prog))
    (s0, m0, _), (s1, m1, prog) = out
    assert m0["loss"] == pytest.approx(m1["loss"], rel=1e-3)
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        assert float((a - b).norm() / b.norm().clamp(min=1e-12)) < 1e-2
    phases = prog.phase_ms()
    assert {"gather", "seq.attention", "seq.router", "seq.experts", "seq.shared",
            "seq.dense_ffn", "forward", "backward", "optimizer", "rows"} <= set(phases)
    counts = profiling.counters()["moe.routed_tokens"]
    assert len(counts) == 2 and sum(counts[0]) > 0

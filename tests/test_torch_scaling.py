"""The port's scaling benchmark (``twotower_tpu_torch/parallel/scaling.py``):
``run_scaling`` at worlds of 1 and 2 gloo ranks (one process a rank) against
the JAX package's ``run_scaling`` on 2 of the 8 forced CPU devices at the same
config: the same JSON keys, mesh layouts, batch and path, and the efficiency
computed as JAX computes it; a world past the devices available is skipped
with JAX's warning. CPU times are not compared (they time the machinery)."""

import json
import logging

import jax
import pytest

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.parallel.scaling import run_scaling as jax_run_scaling
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.parallel import scaling

TINY = {"training.batch_size": 64, "model.embedding_dim": 16,
        "model.user_tower_dims": [32, 16], "model.item_tower_dims": [32, 16]}
SIZES = dict(num_users=1000, num_items=500, steps=2)


def test_run_scaling_matches_jax_keys_and_efficiency(capsys):
    assert jax.device_count() >= 2
    want = jax_run_scaling(JaxConfig().with_overrides(TINY), [1, 2], warmup=1, **SIZES)
    argv = ["--device", "cpu", "--devices", "1", "2", "--num-users", "1000", "--num-items",
            "500", "--steps", "2", "--warmup", "1", "--override",
            *[f"{k}={json.dumps(v)}" for k, v in TINY.items()]]
    assert scaling.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    for g, w in zip(got, want):
        for key in ("devices", "mesh", "global_batch", "sparse_path"):
            assert g[key] == w[key], key
        assert g["examples_per_sec"] > 0 and g["step_ms"] > 0
        per_dev = g["examples_per_sec"] / g["devices"]
        assert g["efficiency"] == round(per_dev / got[0]["examples_per_sec"], 3)
    assert got[0]["efficiency"] == 1.0


def test_run_scaling_skips_a_world_past_the_devices(caplog):
    many = scaling.devices_available("cpu") + 1
    with caplog.at_level(logging.WARNING):
        assert scaling.run_scaling(Config().with_overrides(TINY), [many], device="cpu",
                                   **SIZES) == []
    assert f"skipping {many} devices (only {many - 1} available)" in caplog.text


def test_run_scaling_on_the_gpu_needs_one(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.run_scaling(Config(), [1], **SIZES)

"""The port's scaling model (``twotower_tpu_torch/parallel/scaling_model.py``)
against the JAX package's (``tests/test_scaling_model.py``'s cases): at the
same configurations and the same link rates (JAX's v5e figures, passed in
by name) every traffic term and efficiency is equal, exactly. Its a2a term
equals the bytes that the port's sparse mesh step hands
``all_to_all_single`` on gloo ranks. Its own defaults are the H100's cited
link rates."""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_ranks import run_ranks
from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.parallel import scaling_model as jsm
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.parallel import scaling_model as sm

REPO = Path(__file__).resolve().parent.parent
JAX_RATES = dict(ici_bytes_per_s=jsm.V5E_ICI_BYTES_PER_S, dcn_bytes_per_s=jsm.V5E_DCN_BYTES_PER_S)
A2A_CASES = [
    (8192, 4, 2, 128, 0.0),
    (8192, 4, 2, 128, 1.25),
    (8192, 4, 2, 128, 2.0),
    (16384, 4, 4, 128, 2.0),
    (65536, 16, 4, 256, 2.5),
    (4096, 8, 1, 64, 1.5),
]
BASE = dict(batch=65536, num_data=16, num_model=4, emb_dim=256, out_dim=128,
            capacity_factor=2.5, dense_params=500_000, chips_per_host=4)
TRAFFIC_CASES = {
    "in_batch": {},
    "mixed": {"sampling": "mixed", "num_negatives": 4096},
    "mixed_shard_local": {"sampling": "mixed", "num_negatives": 4096, "shard_local": True},
    "uniform": {"sampling": "uniform", "num_negatives": 4096},
    "text": {"text_tokens": 32},
    "bf16_grads": {"dense_grad_bytes": 2},
    "small_mesh": {"num_data": 2, "num_model": 2, "batch": 8192},
}
PRESETS = ["full_category_8chip.yaml", "catalog_10m_2host.yaml", "pod_571m.yaml"]


@pytest.mark.parametrize("case", A2A_CASES, ids=lambda c: "-".join(map(str, c)))
def test_a2a_term_and_capacity_match_jax(case):
    batch, d, m, e, f = case
    assert sm.a2a_bytes_per_device(*case) == jsm.a2a_bytes_per_device(*case)
    from twotower_tpu.parallel.sparse_spmd import _capacity as jax_capacity
    from twotower_tpu_torch.parallel.sparse_spmd import _capacity

    k = batch // d // m
    assert sm.a2a_capacity(k, d * m, f) == _capacity(k, d * m, f) == jax_capacity(k, d * m, f)


@pytest.mark.parametrize("single_slice", [True, False], ids=["one_domain", "across_hosts"])
@pytest.mark.parametrize("name", list(TRAFFIC_CASES))
def test_traffic_and_efficiency_match_jax(name, single_slice):
    kw = {**BASE, **TRAFFIC_CASES[name], "single_slice": single_slice}
    ours, ref = sm.sparse_step_traffic(**kw), jsm.sparse_step_traffic(**kw)
    assert ours.as_dict() == ref.as_dict()
    for comp in (0.66, 2.78):
        assert (sm.predicted_efficiency(ours, compute_ms=comp, **JAX_RATES).as_dict()
                == jsm.predicted_efficiency(ref, compute_ms=comp).as_dict())


def test_dense_params_match_the_param_trees():
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.training.sparse import split_params

    cfg = Config()
    _, dense = split_params(two_tower.init_params(torch.Generator().manual_seed(0), cfg.model,
                                                  100, 80))
    real = sum(int(np.prod(x.shape)) for x in torch.utils._pytree.tree_leaves(dense))
    assert sm.dense_tower_params(cfg) == real == jsm.dense_tower_params(JaxConfig())


@pytest.mark.parametrize("name", PRESETS)
def test_preset_reports_match_jax(name):
    """Each multi-chip preset's report at JAX's rates and 4 chips a host
    (the JAX dossier's reading) is JAX's, field for field."""
    ours = Config.from_yaml(REPO / "configs" / name)
    ref = JaxConfig.from_yaml(REPO / "configs" / name)
    for comp in (0.59, 0.66):
        a = sm.preset_report(ours, compute_ms=comp, dense_params=sm.dense_tower_params(ours),
                             chips_per_host=4, single_slice=True, **JAX_RATES)
        b = jsm.preset_report(ref, compute_ms=comp, dense_params=jsm.dense_tower_params(ref),
                              chips_per_host=4)
        assert a.as_dict() == b.as_dict()


def test_h100_defaults():
    """The defaults are the cited H100 figures: NVLink 4 one way a GPU, one
    ConnectX-7 400 Gb/s NIC a host, 8 cards a host; a world that fits on
    one host never crosses the network."""
    assert sm.NVLINK_BYTES_PER_S == 900e9 / 2 and sm.NIC_BYTES_PER_S == 400e9 / 8
    assert sm.CARDS_PER_HOST == 8
    defaults = {k: v for k, v in BASE.items() if k != "chips_per_host"}
    one_host = sm.sparse_step_traffic(**{**defaults, "num_data": 2, "num_model": 4})
    two_hosts = sm.sparse_step_traffic(**{**defaults, "num_data": 4, "num_model": 4})
    assert one_host.dcn_per_host == 0 and two_hosts.dcn_per_host > 0
    rep = sm.preset_report(Config().with_overrides({"mesh.num_data": 2, "mesh.num_model": 2}),
                           compute_ms=2.78, dense_params=sm.dense_tower_params(Config()))
    assert rep.ici_ms == round(rep.traffic.ici_per_device / 4.5e11 * 1e3, 4)
    assert rep.meta["single_slice"] and 0 < rep.efficiency_serial <= 1


def test_cli_prints_the_report(capsys):
    sm.main(["--compute-ms", "2.78", "--override", "mesh.num_data=2", "mesh.num_model=2"])
    import json

    out = json.loads(capsys.readouterr().out)
    assert out["meta"]["mesh"] == "2x2" and out["compute_ms"] == 2.78


@pytest.mark.parametrize("layout,factor,sampling", [
    ((2, 1), 2.0, "in_batch"), ((1, 2), 0.0, "in_batch"), ((2, 2), 2.0, "in_batch"),
    ((1, 2), 2.0, "mixed"),
], ids=["2x1-f2", "1x2-f0", "2x2-f2", "1x2-mixed"])
def test_a2a_term_equals_the_bytes_the_step_sends(tmp_path, layout, factor, sampling):
    """One sparse mesh step on gloo ranks: the bytes each rank hands
    ``all_to_all_single`` equal the model's a2a term (ids int32, rows
    float32, the static buckets)."""
    d, m = layout
    batch, emb, negs = 256, 16, 32
    over = {"training.batch_size": batch, "model.embedding_dim": emb,
            "model.user_tower_dims": [32, 16], "model.item_tower_dims": [32, 16],
            "model.dropout_rate": 0.0, "mesh.num_model": m,
            "mesh.a2a_capacity_factor": factor, "retrieval.candidate_sampling": sampling,
            "retrieval.num_negatives": negs}
    rng = np.random.default_rng(6)
    spec = {"overrides": over, "num_users": 400, "num_items": 300,
            "batch": {"user_idx": rng.integers(0, 400, batch).astype(np.int32),
                      "item_idx": rng.integers(0, 300, batch).astype(np.int32),
                      "weight": np.ones(batch, np.float32)}}
    got = run_ranks(workers.a2a_bytes, d * m, tmp_path, spec)
    want = sm.sparse_step_traffic(batch=batch, num_data=d, num_model=m, emb_dim=emb,
                                  out_dim=16, capacity_factor=factor, dense_params=0,
                                  sampling=sampling,
                                  num_negatives=negs if sampling != "in_batch" else 0)
    for r in got:
        assert int(r["bytes"]) == want.a2a_per_device, (r, want)
        assert float(r["dropped"]) == 0.0

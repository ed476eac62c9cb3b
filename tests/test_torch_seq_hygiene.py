"""The sequence user tower's boundaries: its plain reference imports
``torch`` and nothing else; serving refuses a sequence-tower checkpoint by
name; and the MLP configurations' initial weights and train steps are bit
for bit those of the tree before the tower came (digests taken there)."""

from __future__ import annotations

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.training.loop import make_raw_step
from twotower_tpu_torch.training.state import TrainState, make_optimizer, tree_leaves

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "twotower_tpu_torch" / "reference" / "seq_tower.py"


def test_the_reference_imports_torch_and_nothing_else():
    names = set()
    for node in ast.walk(ast.parse(REFERENCE.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0] if node.level == 0 else ".")
    assert names == {"torch"}, names
    code = ("import sys, importlib.util; "
            f"spec = importlib.util.spec_from_file_location('r', {str(REFERENCE)!r}); "
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m); "
            "print(sorted(k for k in sys.modules if k.startswith('twotower')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _sequence_config() -> Config:
    return Config.from_dict({"model": {"user_tower": "sequence"}})


def test_serving_refuses_a_sequence_tower_checkpoint(tmp_path):
    from twotower_tpu_torch.serving.api import build_service
    from twotower_tpu_torch.serving.index import RetrievalIndex

    with pytest.raises(ValueError, match="sequence user tower.*sequence-tower checkpoint"):
        RetrievalIndex.from_checkpoint(_sequence_config(), tmp_path, device="cpu")
    with pytest.raises(ValueError, match="sequence-tower checkpoint"):
        build_service(_sequence_config(), str(tmp_path), device="cpu")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# (initial weights, weights after one step, loss) of the tree before the
# sequence tower, sparse and dense table updates.
BEFORE = {True: ("b463d747bc85a8cf", "507bc5da46d56b8b", 5.474958419799805),
          False: ("b463d747bc85a8cf", "41ac7997541d8982", 5.474958419799805)}


@pytest.mark.parametrize("sparse", [True, False])
def test_mlp_init_and_step_are_bit_for_bit_as_before(sparse):
    cfg = Config().with_overrides({"model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
                                   "model.item_tower_dims": [32, 16], "training.batch_size": 64,
                                   "training.sparse_table_updates": sparse})
    assert cfg.model.user_tower == "mlp"
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 50, 40)
    init = _digest(tree_leaves(params))
    opt = make_optimizer(cfg.training)
    state = TrainState.for_config(params, opt, cfg)
    step = make_raw_step(cfg, opt, num_items=40)
    g = torch.Generator().manual_seed(1)
    batch = {"user_idx": torch.randint(0, 50, (64,), generator=g),
             "item_idx": torch.randint(0, 40, (64,), generator=g), "weight": torch.ones(64)}
    state, m = step(state, batch, torch.Generator().manual_seed(2), torch.full((40,), -3.0))
    assert (init, _digest(tree_leaves(state.params)), float(m["loss"])) == BEFORE[sparse]


def test_the_sequence_block_is_validated():
    with pytest.raises(ValueError, match="user_tower"):
        Config.from_dict({"model": {"user_tower": "transformer"}})
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        Config.from_dict({"model": {"user_tower": "sequence",
                                    "sequence": {"n_routed_experts": 4, "num_experts_per_tok": 6}}})
    with pytest.raises(ValueError, match="first_k_dense_replace"):
        Config.from_dict({"model": {"sequence": {"num_hidden_layers": 2,
                                                 "first_k_dense_replace": 3}}})
    cfg = Config.from_yaml(REPO / "configs" / "torch" / "seq_dsv2lite_1chip.yaml")
    s = cfg.model.sequence
    assert (cfg.model.user_tower, s.hidden_size, s.num_hidden_layers, s.n_routed_experts,
            s.num_experts_per_tok, s.kv_lora_rank, cfg.training.batch_size) == (
        "sequence", 2048, 5, 64, 6, 512, 32768)

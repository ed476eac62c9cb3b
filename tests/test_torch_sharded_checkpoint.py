"""Mesh state stays sharded through save, restore and evaluation, on gloo
ranks on the CPU:

- a 2x2 sparse save (every rank writes its own rows of each table leaf and
  nothing else) restores at 1x1, 1x4 and 2x1 and on one device, equal to
  the saved state bit for bit;
- a 2x2 dense-path save (tables over ``model``: only the data-index-0 peer
  of each model shard writes) restores at 1x2 and on one device;
- a spy on ``Axis.all_gather`` sees no full table leaf returned in a save,
  a restore or an ``Evaluator(mesh=)`` pass (the pass's all-gathers carry
  the search's ``[B, k]`` candidates only), and the sharded evaluation
  equals the one-device ``Evaluator`` within 1e-6;
- the v1 fixture (``tests/fixtures/adam_v1_checkpoint``, one ``state.pt``)
  restores at a mesh layout;
- an incomplete step directory (no ``meta.json``, a stale file) is removed
  before a mesh save; keep-pruning and ``best_step`` work on the layout.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_ranks import flatten, run_ranks
from twotower_tpu_torch import bridge
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.training.state import init_train_state, make_optimizer
from twotower_tpu_torch.utils.checkpoint import CheckpointManager

USERS, ITEMS = 200, 120  # tables of 256 and 128 rows: every layout divides them
SMALL = {"model.embedding_dim": 8, "model.user_tower_dims": [16, 8],
         "model.item_tower_dims": [16, 8], "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "training.batch_size": 32,
         "retrieval.top_k_eval": [5, 10]}
ADAM_V1 = Path(__file__).parent / "fixtures" / "adam_v1_checkpoint"


def _state(over, seed=0):
    """A one-device state with every leaf random (moments included), as
    numpy."""
    cfg = Config().with_overrides({**SMALL, **over})
    state = init_train_state(cfg, make_optimizer(cfg.training), USERS, ITEMS, device="cpu")
    gen = torch.Generator().manual_seed(seed)
    tree = bridge.state_to_numpy(state)

    def noise(x):
        if isinstance(x, dict):
            return {k: noise(v) for k, v in x.items()}
        if isinstance(x, list):
            return [noise(v) for v in x]
        if isinstance(x, np.ndarray):
            return torch.randn(x.shape, generator=gen).abs().numpy().astype(x.dtype)
        return x

    return {**tree, "params": noise(tree["params"]), "opt_state": noise(tree["opt_state"]),
            "table_state": noise(tree["table_state"])}


def _spec(over, layout, ckpt, **kw):
    rng = np.random.default_rng(3)
    return {"overrides": {**SMALL, **over, "mesh.num_model": layout[1]}, "ckpt_dir": str(ckpt),
            "num_users": USERS, "num_items": ITEMS, "eval_batch": 64,
            "users": rng.integers(0, USERS, 150).astype(np.int32),
            "items": rng.integers(0, ITEMS, 150).astype(np.int32), **kw}


def _saved(got):
    return {k[len("state/"):]: v for k, v in got.items() if k.startswith("state/")}


def _assert_equal(got, want):
    got = _saved(got) if any(k.startswith("state/") for k in got) else got
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _table_shapes(tree):
    """``(rows, row width)`` of every table leaf (tables and their moments)."""
    return {(v.shape[0], v.shape[1]) for k, v in flatten(tree).items()
            if any(t in k for t in ("user_embedding", "item_embedding")) and v.ndim == 2}


def _one_device(over, ckpt, step=None):
    cfg = Config().with_overrides({**SMALL, **over})
    state = init_train_state(cfg, make_optimizer(cfg.training), USERS, ITEMS, device="cpu")
    state, _ = CheckpointManager(ckpt).restore(state, step=step)
    return cfg, state


def _check_no_table_gathered(got, tables):
    for r in got:
        for what in ("save", "restore", "encode"):
            shapes = {tuple(x) for x in r.get(f"gathered/{what}", np.zeros((0, 2))).tolist()}
            assert not shapes & tables, (what, shapes)
            if what != "encode":  # only the search's [B, k] candidates are gathered
                assert not shapes, (what, shapes)


def _check_metrics(got, cfg, state, spec):
    want = Evaluator(cfg, ITEMS, batch_size=spec["eval_batch"], device="cpu").evaluate(
        state.params, spec["users"], spec["items"])
    for r in got:
        for k, v in want.items():
            np.testing.assert_allclose(r[f"metrics/{k}"], v, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def sparse_2x2(tmp_path_factory):
    """A 2x2 sparse-path state saved at steps 3, 4 and 5 (keep 2)."""
    work = tmp_path_factory.mktemp("sparse_2x2")
    start = _state({})
    spec = _spec({}, (2, 2), work / "ckpt", mode="save", state=start, steps=[3, 4, 5],
                 metrics=[0.2, 0.5, 0.3], keep=2)
    got = run_ranks(workers.sharded_checkpoint, 4, work / "ranks", spec)
    return work / "ckpt", start, got


def test_sparse_2x2_save_writes_each_ranks_own_rows(sparse_2x2):
    ckpt, start, got = sparse_2x2
    _check_no_table_gathered(got, _table_shapes(start))
    step = ckpt / "step_0000000005"
    assert sorted(p.name for p in step.iterdir()) == [
        "manifest.json", "meta.json", "rank_00000.pt", "rank_00001.pt", "rank_00002.pt",
        "rank_00003.pt"]
    manifest = json.loads((step / "manifest.json").read_text())
    user = manifest["leaves"]["params/user_embedding"]
    assert user["shape"] == [256, 8] and user["axis"] == "combined"
    assert user["parts"] == [[f"rank_{r:05d}.pt", 64 * r, 64 * (r + 1)] for r in range(4)]
    # Rank 3 holds rows 192-255 of each table leaf and no replicated leaf.
    own = torch.load(step / "rank_00003.pt", weights_only=True)
    assert sorted(own) == ["params/item_embedding", "params/user_embedding",
                           "table_state/item_embedding/moments",
                           "table_state/user_embedding/moments"]
    np.testing.assert_array_equal(own["params/user_embedding"].numpy(),
                                  start["params"]["user_embedding"][192:])
    for r in got:  # keep-pruning and best_step on the sharded layout
        assert r["steps"].tolist() == [4, 5] and int(r["best"]) == 4
        assert int(r["shard_rows"]) == 64


@pytest.mark.parametrize("layout", [(1, 1), (1, 4), (2, 1)], ids=lambda x: f"{x[0]}x{x[1]}")
def test_sparse_2x2_restores_at_other_layouts(sparse_2x2, tmp_path, layout):
    ckpt, start, _ = sparse_2x2
    spec = _spec({}, layout, ckpt, mode="restore")
    got = run_ranks(workers.sharded_checkpoint, layout[0] * layout[1], tmp_path, spec)
    want = flatten({**start, "step": 5})
    for r in got:
        _assert_equal(r, want)
        assert int(r["shard_rows"]) == 256 // (layout[0] * layout[1])
    _check_no_table_gathered(got, _table_shapes(start))
    cfg, one = _one_device({}, ckpt)
    _assert_equal(flatten(bridge.state_to_numpy(one)), want)
    _check_metrics(got, cfg, one, spec)


def test_dense_2x2_save_restores_at_1x2_and_on_one_device(tmp_path):
    over = {"training.sparse_table_updates": False}
    start = _state(over, seed=1)
    save = _spec(over, (2, 2), tmp_path / "ckpt", mode="save", state=start, steps=[7],
                 metrics=[0.1])
    saved = run_ranks(workers.sharded_checkpoint, 4, tmp_path / "s", save)
    step = tmp_path / "ckpt" / "step_0000000007"
    # Tables over model, replicated along data: ranks 0 and 1 (d = 0) write.
    assert sorted(p.name for p in step.glob("rank_*.pt")) == ["rank_00000.pt",
                                                               "rank_00001.pt"]
    want = flatten({**start, "step": 7})
    restore = _spec(over, (1, 2), tmp_path / "ckpt", mode="restore")
    got = run_ranks(workers.sharded_checkpoint, 2, tmp_path / "r", restore)
    for r in saved + got:
        _assert_equal(r, want)
    _check_no_table_gathered(saved + got, _table_shapes(start))
    cfg, one = _one_device(over, tmp_path / "ckpt")
    _assert_equal(flatten(bridge.state_to_numpy(one)), want)
    _check_metrics(got, cfg, one, restore)


def test_v1_checkpoint_restores_at_a_mesh_layout(tmp_path):
    """The single-file v1 layout: each rank reads its rows of ``state.pt``."""
    over = {"model.embedding_dim": 4, "model.user_tower_dims": [8, 4],
            "model.item_tower_dims": [8, 4], "training.batch_size": 8}
    spec = {**_spec(over, (1, 2), ADAM_V1, mode="restore",
                    format="twotower_tpu_torch.checkpoint.v1"), "num_users": 10,
            "num_items": 6, "users": np.arange(10, dtype=np.int32),
            "items": np.arange(10, dtype=np.int32) % 6}
    got = run_ranks(workers.sharded_checkpoint, 2, tmp_path, spec)
    cfg = Config().with_overrides({**SMALL, **over})
    one = init_train_state(cfg, make_optimizer(cfg.training), 10, 6, device="cpu")
    one, _ = CheckpointManager(ADAM_V1).restore(one)
    want = flatten(bridge.state_to_numpy(one))
    for r in got:
        _assert_equal(r, want)


def test_incomplete_step_is_removed_before_a_mesh_save(tmp_path):
    ckpt = tmp_path / "ckpt"
    stale = ckpt / "step_0000000002"
    stale.mkdir(parents=True)
    (stale / "rank_00007.pt").write_bytes(b"left by a crashed save of a larger world")
    start = _state({}, seed=2)
    spec = _spec({}, (1, 2), ckpt, mode="save", state=start, steps=[2], metrics=[0.4])
    got = run_ranks(workers.sharded_checkpoint, 2, tmp_path / "r", spec)
    assert sorted(p.name for p in stale.iterdir()) == [
        "manifest.json", "meta.json", "rank_00000.pt", "rank_00001.pt"]
    assert got[0]["steps"].tolist() == [2]
    _, one = _one_device({}, ckpt)
    _assert_equal(flatten(bridge.state_to_numpy(one)), flatten({**start, "step": 2}))

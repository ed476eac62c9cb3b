"""Users' histories for the sequence user tower (``data/sequences.py``), built
from a small prepare-data artifact in time order, and the tower through
``train-model --prepared-dir`` and ``evaluate-model`` on the CPU at a small
size (hidden 64, 8 experts top 2, windows of 16, streams of 96 slots)."""

from __future__ import annotations

import json

import numpy as np
import pandas as pd
import pytest
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.data import generate_interactions
from twotower_tpu_torch.data.prepare import main as prepare_main
from twotower_tpu_torch.data.prepared import PreparedDataset
from twotower_tpu_torch.data.sequences import (
    StreamDataset,
    UserHistories,
    pack_streams,
    user_slots,
)

CONFIG = "configs/torch/seq_dsv2lite_1chip.yaml"
SMALL = ["model.embedding_dim=16", "model.user_tower_dims=[32,16]",
         "model.item_tower_dims=[32,16]", "model.compute_dtype=float32",
         "model.sequence.hidden_size=64", "model.sequence.num_hidden_layers=3",
         "model.sequence.intermediate_size=96", "model.sequence.moe_intermediate_size=32",
         "model.sequence.n_routed_experts=8", "model.sequence.num_experts_per_tok=2",
         "model.sequence.n_shared_experts=1", "model.sequence.num_attention_heads=4",
         "model.sequence.kv_lora_rank=32", "model.sequence.qk_nope_head_dim=16",
         "model.sequence.qk_rope_head_dim=8", "model.sequence.v_head_dim=16",
         "model.sequence.max_window=16", "training.batch_size=96", "training.epochs=2",
         "preprocessing.min_interactions_per_user=2",
         "preprocessing.min_interactions_per_item=2"]


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seq_prep")
    raw = generate_interactions(num_users=200, num_items=100, num_interactions=5000)
    (tmp / "raw").mkdir()
    pd.DataFrame({"user_id": raw.user_id, "parent_asin": raw.item_id, "rating": raw.rating,
                  "timestamp": raw.timestamp}).to_parquet(tmp / "raw" / "all_reviews.parquet")
    assert prepare_main(["--data-dir", str(tmp / "raw"), "--output-dir", str(tmp / "prepared"),
                         "--no-balance", "--override", *SMALL[-2:]]) == 0
    return tmp / "prepared"


def _train_split(prepared):
    ds = PreparedDataset(prepared)
    rule = ds.temporal_rule(0.8, 0.1)
    return ds, ds.load_splits(rule, ("train", "test"), extra_columns=())


def test_slots_follow_each_user_in_time_order(prepared):
    ds, splits = _train_split(prepared)
    train = splits["train"]
    user, item = train["user_idx"], train["item_idx"]
    hist, target, pos = user_slots(user, item, 16)
    per_user = {}
    for u, i in zip(user, item):  # the split's rows are in time order
        per_user.setdefault(int(u), []).append(int(i))
    want_hist, want_target, want_pos = [], [], []
    for u in sorted(per_user):
        seq = per_user[u]
        want_hist += seq[:-1]
        want_target += seq[1:]
        want_pos += [t % 16 for t in range(len(seq) - 1)]
    assert hist.tolist() == want_hist and target.tolist() == want_target
    assert pos.tolist() == want_pos


def test_streams_hold_every_slot_once_and_restart_positions():
    hist = np.arange(100, 160)
    pos = np.array([0, 1, 2, 3, 4] * 12)  # twelve windows of five
    cols = pack_streams(hist, hist + 1000, pos, 16, seed=0)
    assert len(cols["weight"]) == 64 and cols["weight"].sum() == 60
    real = cols["weight"] > 0
    assert sorted(cols["hist_idx"][real].tolist()) == hist.tolist()
    assert (cols["item_idx"][real] == cols["hist_idx"][real] + 1000).all()
    p = cols["pos"]
    assert (p[::16] == 0).all()  # a window cut at a stream's end restarts in the next
    assert p.max() < 5 and (cols["pos"][~real] == 0).all()
    for i in range(1, 64):  # within a window the slots stay in order
        if p[i] > 0:
            assert p[i] == p[i - 1] + 1 and cols["hist_idx"][i] == cols["hist_idx"][i - 1] + 1


def test_histories_are_the_last_train_items(prepared):
    ds, splits = _train_split(prepared)
    train = splits["train"]
    h = UserHistories(train["user_idx"], train["item_idx"], ds.num_users, 4, pad_item=999,
                      device="cpu")
    users = torch.tensor([int(train["user_idx"][0]), int(train["user_idx"][-1])])
    windows, lengths = h.windows(users)
    for row, n, u in zip(windows.tolist(), lengths.tolist(), users.tolist()):
        seq = train["item_idx"][train["user_idx"] == u].tolist()
        assert n == min(len(seq), 4) and row[:n] == seq[-n:] and row[n:] == [999] * (4 - n)
    empty = UserHistories(np.array([0]), np.array([5]), 3, 4, pad_item=999, device="cpu")
    windows, lengths = empty.windows(torch.tensor([2]))
    assert windows.tolist() == [[999] * 4] and lengths.tolist() == [1]


def test_stream_dataset_packs_the_train_split(prepared):
    _, splits = _train_split(prepared)
    train = splits["train"]
    cfg = Config.from_yaml(CONFIG).with_overrides(
        {k: json.loads(v) if v[0] in "[0123456789" else v
         for k, v in (s.split("=", 1) for s in SMALL)})
    data = StreamDataset(train["user_idx"], train["item_idx"], cfg, device="cpu")
    n_users = len(np.unique(train["user_idx"]))
    assert data.num_examples == len(train["user_idx"]) - n_users
    assert data.num_steps * 96 == len(data.columns["weight"])
    assert int(data.columns["weight"].sum()) == data.num_examples


def test_train_and_evaluate_on_the_cli(prepared, tmp_path, capsys):
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.training.train import main as train_main

    ckpt = tmp_path / "ck"
    assert train_main(["--device", "cpu", "--config", CONFIG, "--prepared-dir", str(prepared),
                       "--checkpoint-dir", str(ckpt), "--writers", "jsonl", "--override",
                       *SMALL]) == 0
    summary = json.loads((ckpt / "train_summary.json").read_text())
    assert summary["execution_rung"] == "device_loop" and summary["epochs_run"] == 2
    assert summary["test"]["recall@10"] > 10 / 100  # above random over 100 items
    capsys.readouterr()
    assert eval_main(["--device", "cpu", "--prepared-dir", str(prepared), "--checkpoint-dir",
                      str(ckpt), "--subset", "test"]) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["metrics"]
    for k, v in summary["test"].items():
        assert metrics[k] == pytest.approx(v, abs=1e-6), k
    with pytest.raises(SystemExit, match="device loop"):
        train_main(["--device", "cpu", "--config", CONFIG, "--prepared-dir", str(prepared),
                    "--checkpoint-dir", str(tmp_path / "h"), "--exec", "host", "--override",
                    *SMALL])

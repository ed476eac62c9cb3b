"""The sequence tower's cell (``seq_dsv2lite_train``): the readers' counts
pinned at the configuration's published widths, the traffic's length law,
and a whole run of the cell at a tiny size on the CPU, which comes out
correct with sound weights and not with the float8 control."""

import json
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.harness.manifest import load_cell, load_module
from perfbench.harness.runner import run_cell
from perfbench.tests.tiny import REPO, tiny_root

CELL = "seq_dsv2lite_train"
CONFIG = json.loads((REPO / "perfbench" / "configs" / "seq_dsv2lite_1chip.json").read_text())
TRAFFIC = json.loads((REPO / "perfbench" / "traffic" / "train_seq_packed_32k.json").read_text())
MODEL = CONFIG["port"]["model"]
TINY_SEQ = {"hidden_size": 64, "num_hidden_layers": 3, "first_k_dense_replace": 1,
            "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
            "num_experts_per_tok": 2, "n_shared_experts": 1, "num_attention_heads": 4,
            "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
            "v_head_dim": 16, "max_window": 16}


def metric(name):
    return load_module(REPO / "perfbench" / "metrics" / f"{name}.py", "seq_counts_" + name)


def test_parameter_counts_at_the_published_widths():
    m = metric("seq_step_mfu")
    s = MODEL["sequence"]
    assert m.total_params(s, 128, 128) == 2_420_924_928  # 2.42 B
    assert m.active_params(s, 128, 128) == 413_925_376  # 413.9 M a slot
    h, i, n = 2048, 1408, 64
    assert 3 * h * i * n == 553_648_128  # each MoE layer's routed experts: 553.6 M


def test_length_law_and_flops_per_example():
    m = metric("seq_step_mfu")
    w = TRAFFIC["window"]
    lengths = np.arange(4, 65)
    p = 1.0 / lengths
    assert (w["min"], w["max"], w["exponent"]) == (4, 64, 1.0)
    assert float((p * lengths).sum() / p.sum()) == pytest.approx(20.96, abs=0.01)  # mean length
    assert m.mean_context(w) == pytest.approx(17.5)
    assert m.flops_per_example(MODEL, 32768, w) == pytest.approx(2.5128e9, rel=1e-4)


def test_experts_work_and_roofline():
    m = metric("moe.experts_roofline")
    flops, nbytes = m.work(MODEL, 32768)
    assert flops == 3 * 2 * 32768 * 8 * 3 * 2048 * 1408 * 4  # 54.4 TFLOP a step
    assert flops / 989e12 > nbytes / 3.35e12  # bound by the products
    assert flops / 989e12 * 1e3 == pytest.approx(55.03, abs=0.01)  # ms at the peak


def test_traffic_windows_fill_each_stream():
    from perfbench.drivers import train_seq

    lens = train_seq.window_lengths(TRAFFIC["window"], 32768, 4, 2**31 + 5)
    cum = np.cumsum(lens)
    assert set(range(32768, 4 * 32768 + 1, 32768)) <= set(cum.tolist())
    assert lens.min() >= 1 and lens.max() <= 64
    assert statistics.mean(lens.tolist()) == pytest.approx(20.96, rel=0.05)


def test_load_reader_takes_the_worst_layer(monkeypatch):
    from twotower_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters",
                        lambda: {"moe.routed_tokens": [[2.0, 2.0, 2.0, 2.0], [1.0, 1.0, 1.0, 5.0]]})
    assert metric("moe.load_max_over_mean.train").read(None) == pytest.approx(2.5)


def _tiny(root):
    conf_path = root / "perfbench" / "configs" / "seq_dsv2lite_1chip.json"
    conf = json.loads(conf_path.read_text())
    conf["num_users"], conf["num_items"] = 300, 500
    conf["port"]["model"].update({"embedding_dim": 16, "user_tower_dims": [32, 16],
                                  "item_tower_dims": [32, 16]})
    conf["port"]["model"]["sequence"].update(TINY_SEQ)
    conf["port"]["training"]["batch_size"] = 96
    conf_path.write_text(json.dumps(conf))
    t_path = root / "perfbench" / "traffic" / "train_seq_packed_32k.json"
    t = json.loads(t_path.read_text())
    t.update({"stream": 96, "streams_per_epoch": 3, "reference_block": 32,
              "window": {"dist": "zipf", "exponent": 1.0, "min": 2, "max": 16}})
    # The cell's limits are set at the published widths. At hidden 64, over
    # 96 slots, bfloat16's rounding weighs more (sound readings up to 7e-4
    # of the loss, 7e-3 of a leaf's change, 3.6e-4 of the watched loss, 0.5%
    # route flips; my CPU runs), so the tiny copy states its own limits,
    # between those and its float8 control's least (8e-3, 0.08, 0.84,
    # 2.2e-3, 0.13, 0.096, 0.073).
    t["check"] = {"loss_gap": 3e-3, "grad1_gap": 0.03, "change3_gap": 0.05,
                  "window_loss_gap": 1.2e-3, "window_grad_gap": 0.05,
                  "window_change_gap": 0.03, "route_flip_share": 0.03}
    t["items"].update({"clusters": 16, "latent_dim": 4, "chunks": 4})
    t_path.write_text(json.dumps(t))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny(tiny_root(tmp_path_factory.mktemp("tiny_seq")))


def test_a_tiny_run_is_correct_and_the_control_is_not(root):
    from perfbench.control import readings

    cell = load_cell(root, CELL)
    line = run_cell(cell, 2**31 + 77, 0.5, False, "cpu", log=lambda m: None)
    assert line["correct"], json.dumps(line["compared"])
    assert line["failed"] == 0 and line["attempted"] > 0
    limits = cell.traffic["check"]
    got = readings(cell, 2**31 + 99, 0.3, "cpu")
    assert all(got["program"][k] <= limits[k] for k in limits), got["program"]
    assert any(got["control"][k] > limits[k] for k in limits), got["control"]


def test_the_parent_program_is_refused():
    """A program whose Config drops ``model.user_tower`` fails at once."""
    from perfbench.drivers import train_seq

    with pytest.raises(RuntimeError, match="sequence user tower"):
        train_seq._require_sequence_tower(
            SimpleNamespace(model=SimpleNamespace(user_tower="mlp")))

"""Multi-process training on the port's mesh, at the Trainer and CLI level
(the twins of ``tests/test_multihost.py`` / ``tests/multihost_worker.py``
and of ``tests/test_prepared.py``'s multi-host input cases):

- ``Trainer(mesh=)`` on 2 and 4 gloo ranks against the JAX package's
  single-device ``Trainer.fit`` from one state (the JAX tests hold JAX's
  mesh path equal to it): per-epoch loss rtol 1e-4, validation metrics
  within one rank flip, final state rtol 1e-4 / atol 1e-5;
- the lifecycle: validation on the sharded evaluator, early stopping and
  collective checkpoints that every rank agrees on, then a resume;
- ``DeviceTrainer(mesh=)`` against the port's one-device ``DeviceTrainer``;
- the input path: this rank's rows (``process_row_spans``) and the sharded
  read of a prepared artifact, against the JAX package's readers;
- two ``train-model --mesh --coordinator ... --device cpu`` processes agree
  with each other and with the one-process run, and ``evaluate-model
  --mesh`` on two processes equals ``evaluate-model`` within 1e-6.

Every multi-process run has its own timeout (120 s a spawn; 180 s a CLI
pair), past which its processes are killed.
"""

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import torch_mesh_workers as workers
from test_torch_bridge import jax_state_to_numpy
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_trainer import OVERRIDES, STATE_TOL, _jax_fit
from test_torch_trainer import _setup as trainer_setup
from torch_mesh_jax import assert_state_close, layout_id
from torch_mesh_ranks import run_ranks

REPO = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 180


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's single-device fit of ``test_torch_trainer``'s setting."""
    cfg, jcfg, pp, splits = trainer_setup()
    jres, start = _jax_fit(jcfg, pp, splits)
    return jres, start, pp, splits


def _trainer_spec(pp, splits, start, ckpt_dir, extra=None, layout=(2, 1)):
    return {
        "overrides": {**OVERRIDES, **(extra or {}), "mesh.num_model": layout[1]},
        "train": (splits.train.user_idx, splits.train.item_idx),
        "val": (splits.val.user_idx, splits.val.item_idx),
        "num_users": len(pp.vocab.users), "num_items": len(pp.vocab.items),
        "log_q": np.log(pp.vocab.items.frequencies + 1e-12), "state": start,
        "ckpt_dir": str(ckpt_dir), "eval_batch": 256, "state_out": True,
    }


@pytest.mark.parametrize("layout", [(2, 1), (1, 2), (2, 2)], ids=layout_id)
def test_mesh_trainer_matches_jax_single_device(tmp_path, jax_fit, layout):
    jres, start, pp, splits = jax_fit
    spec = _trainer_spec(pp, splits, start, tmp_path / "ckpt", layout=layout)
    out = run_ranks(workers.trainer_fit, layout[0] * layout[1], tmp_path, spec)
    flip = 1.0 / len(splits.val)
    for r in out:  # every rank saw the same run
        for i, ref in enumerate(jres.history):
            np.testing.assert_allclose(r[f"history/{i}/loss"], ref["loss"], rtol=1e-4)
            for key in ("val/recall@10", "val/ndcg@10", "val/mrr"):
                assert abs(float(r[f"history/{i}/{key}"]) - ref[key]) <= flip, key
        assert int(r["best_step"]) == jres.best_step
    got = out[0]
    ref = jax_state_to_numpy(jres.state)
    assert int(got["state/step"]) == ref["step"]
    assert_state_close(got, {k: ref[k] for k in ("params", "table_state")},
                       lr=0.0, steps=0, **STATE_TOL)


def test_lifecycle_early_stop_checkpoints_and_resume(tmp_path):
    """The JAX multihost lifecycle's twin on 2 ranks (1 data x 2 model):
    validation every epoch, patience 1, collective checkpoints in one
    directory; both ranks agree on the history, the stop, the best step and
    the saved steps. Then a resume from the latest checkpoint trains on."""
    over = {"model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
            "model.item_tower_dims": [32, 16], "model.dropout_rate": 0.0,
            "training.batch_size": 32, "training.epochs": 3, "training.patience": 1,
            "training.validation_freq": 1, "training.log_every_steps": 1000,
            "preprocessing.min_interactions_per_user": 2,
            "preprocessing.min_interactions_per_item": 2, "mesh.num_model": 2}
    ckpt = tmp_path / "ckpt"
    r = run_ranks(workers.trainer_fit, 2, tmp_path / "a", {"overrides": over,
                                                         "ckpt_dir": str(ckpt)})
    keys = [k for k in r[0] if not k.startswith("params")]
    for k in keys:
        np.testing.assert_array_equal(r[0][k], r[1][k], err_msg=k)
    steps = list(r[0]["ckpt_steps"])
    assert steps and int(r[0]["best_step"]) in steps
    assert sorted(p.name for p in ckpt.iterdir()) == [f"step_{s:010d}" for s in steps]
    r2 = run_ranks(workers.trainer_fit, 2, tmp_path / "b",
                   {"overrides": {**over, "training.epochs": 5}, "ckpt_dir": str(ckpt),
                    "resume": True})
    for rank in r2:
        assert int(rank["restored_step"]) == max(steps)
        assert int(rank["best_step"]) > 0
    assert max(r2[0]["ckpt_steps"]) > max(steps)


def test_mesh_device_trainer_matches_one_device(tmp_path, jax_fit):
    """``DeviceTrainer(mesh=)`` on a 2x2 mesh against the port's one-device
    ``DeviceTrainer`` (the same permutation: both draw it from
    ``epoch_seed``), from one state."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.training.device_loop import DeviceDataset, DeviceTrainer
    from twotower_tpu_torch.training.train import _EncodedColumns

    _, start, pp, splits = jax_fit
    spec = _trainer_spec(pp, splits, start, tmp_path / "ckpt", {"training.host_dedup": False},
                         layout=(2, 2))
    spec["device_loop"] = True
    got = run_ranks(workers.trainer_fit, 4, tmp_path, spec)[0]
    cfg = Config().with_overrides(spec["overrides"])
    ev = Evaluator(cfg, spec["num_items"], batch_size=256, device="cpu")
    trainer = DeviceTrainer(cfg, log_q=spec["log_q"], num_items=spec["num_items"],
                            evaluate_fn=ev.make_evaluate_fn(*spec["val"]), device="cpu")
    res = trainer.fit(bridge.state_from_numpy(start),
                      DeviceDataset.from_interactions(_EncodedColumns(*spec["train"]),
                                                      cfg.training.batch_size, device="cpu"))
    flip = 1.0 / len(splits.val)
    for i, rec in enumerate(res.history):
        np.testing.assert_allclose(got[f"history/{i}/loss"], rec["loss"], rtol=1e-4)
        assert abs(float(got[f"history/{i}/val/recall@10"]) - rec["val/recall@10"]) <= flip
    ref = bridge.state_to_numpy(res.state)
    assert_state_close(got, {k: ref[k] for k in ("params", "table_state")}, lr=0.0, steps=0,
                       **STATE_TOL)


def _fake_mesh(num_data, d_idx):
    return SimpleNamespace(num_data=num_data, d_idx=d_idx)


@pytest.mark.parametrize("layout", [(4, 2), (2, 1), (1, 4)], ids=layout_id)
def test_process_row_spans_match_jax_batch_sharding(layout):
    """Rank ``d*S + m``'s rows are the JAX batch sharding's rows of device
    ``(d, m)`` (``P(data)`` over the mesh)."""
    from twotower_tpu.config import MeshConfig
    from twotower_tpu.parallel import build_mesh
    from twotower_tpu.parallel.sharding import batch_shardings
    from twotower_tpu_torch.parallel.sharding import process_row_spans

    d, s = layout
    mesh = build_mesh(MeshConfig(num_data=d, num_model=s), jax.devices()[:d * s])
    idx = batch_shardings(mesh, MeshConfig()).devices_indices_map((32,))
    for rank, dev in enumerate(mesh.devices.reshape(-1)):
        sl = idx[dev][0]
        want = [(sl.start or 0, 32 if sl.stop is None else sl.stop)]
        assert process_row_spans(_fake_mesh(d, rank // s), 32) == want


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    from test_torch_cli_prepared import OVERRIDES as PREP_OVERRIDES
    import pandas as pd

    from twotower_tpu_torch.data import generate_interactions
    from twotower_tpu_torch.data.prepare import main as prepare_main

    tmp = tmp_path_factory.mktemp("mp_prep")
    raw = generate_interactions(num_users=200, num_items=100, num_interactions=5000)
    (tmp / "raw").mkdir()
    pd.DataFrame({"user_id": raw.user_id, "parent_asin": raw.item_id, "rating": raw.rating,
                  "timestamp": raw.timestamp}).to_parquet(tmp / "raw" / "all_reviews.parquet")
    assert prepare_main(["--data-dir", str(tmp / "raw"), "--output-dir", str(tmp / "prepared"),
                         "--no-balance", "--override", *PREP_OVERRIDES[-2:]]) == 0
    return tmp / "prepared"


@pytest.mark.parametrize("spans", [[(0, 32)], [(32, 64)], [(0, 16), (48, 64)]])
@pytest.mark.parametrize("shard_input", [False, True])
def test_streamed_rank_rows_match_jax(prepared, spans, shard_input):
    """A rank's streamed rows (``host_spans``, replicated or sharded read)
    equal the JAX package's reader's, bit for bit, over two epochs."""
    from twotower_tpu.data.prepared import PreparedDataset as JaxPrepared
    from twotower_tpu_torch.data.prepared import PreparedDataset

    outs = []
    for cls in (PreparedDataset, JaxPrepared):
        ds = cls(str(prepared), batch_rows=512)
        rule = ds.temporal_rule(0.8, 0.1)
        pipe = ds.train_pipeline(rule, 64, shuffle_buffer=512, host_spans=spans,
                                 shard_input=shard_input)
        outs.append([b for e in (0, 1) for b in pipe.epoch(e)])
    assert len(outs[0]) == len(outs[1]) > 0
    for a, b in zip(*outs):
        assert a["user_idx"].shape == (sum(hi - lo for lo, hi in spans),)
        for k in ("user_idx", "item_idx", "weight"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


CLI_OVERRIDES = [
    "training.batch_size=64", "training.epochs=2", "model.embedding_dim=16",
    "model.user_tower_dims=[32,16]", "model.item_tower_dims=[32,16]",
    "model.compute_dtype=float32", "model.dropout_rate=0.0", "training.host_dedup=false",
    "preprocessing.min_interactions_per_user=2", "preprocessing.min_interactions_per_item=2",
]
SYNTH = ["--synthetic", "--synthetic-users", "200", "--synthetic-items", "100",
         "--synthetic-interactions", "5000"]


def _cli_pair(module: str, args: list, store: Path, extra_overrides=()) -> list[dict]:
    """Two processes of ``module``'s CLI on a file:// rendezvous at ``store``;
    their stdout's last line (the JSON result) each."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", module, "--device", "cpu", "--mesh", "--coordinator",
         f"file://{store}", "--num-processes", "2", "--process-id", str(i), *args,
         "--override", *CLI_OVERRIDES, *extra_overrides],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CLI_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(5)
    return outs


def test_two_cli_processes_match_one(tmp_path):
    """``train-model --mesh`` as two processes (1 data x 2 model) against
    the one-process run: the same losses (rtol 1e-4) and test metrics
    (within a rank flip); rank 0 alone wrote the artifacts, a checkpoint in
    the single-device layout. Then ``evaluate-model --mesh`` on two
    processes (2 data x 1 model) equals ``evaluate-model`` within 1e-6."""
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.training.train import main as train_main

    ckpt = tmp_path / "mesh"
    two = _cli_pair("twotower_tpu_torch.training.train",
                    [*SYNTH, "--checkpoint-dir", str(ckpt), "--writers", "jsonl"],
                    tmp_path / "store", ["mesh.num_model=2"])
    assert [o["mesh"]["rank"] for o in two] == [0, 1]
    assert two[0]["test"] == two[1]["test"]
    assert train_main(["--device", "cpu", *SYNTH, "--checkpoint-dir", str(tmp_path / "one"),
                       "--writers", "jsonl", "--override", *CLI_OVERRIDES]) == 0
    one = json.loads((tmp_path / "one" / "train_summary.json").read_text())
    saved = json.loads((ckpt / "train_summary.json").read_text())
    assert saved["mesh"]["rank"] == 0 and saved["best_step"] == one["best_step"]
    flip = 1.0 / 500
    for k, v in one["test"].items():
        assert abs(two[0]["test"][k] - v) <= flip, k

    def losses(d):
        recs = [json.loads(x) for x in (d / "metrics.jsonl").read_text().splitlines()]
        return [r["loss"] for r in recs if "epoch" in r]

    np.testing.assert_allclose(losses(ckpt), losses(tmp_path / "one"), rtol=1e-4)
    ev = _cli_pair("twotower_tpu_torch.evaluation.evaluate",
                   [*SYNTH, "--checkpoint-dir", str(ckpt)], tmp_path / "store_eval",
                   ["mesh.num_model=1"])
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert eval_main(["--device", "cpu", *SYNTH, "--checkpoint-dir", str(ckpt),
                          "--override", *CLI_OVERRIDES]) == 0
    plain = json.loads(buf.getvalue().strip().splitlines()[-1])
    for r in ev:
        assert r["checkpoint_step"] == plain["checkpoint_step"]
        for k, v in plain["metrics"].items():
            assert r["metrics"][k] == pytest.approx(v, abs=1e-6), k


def test_two_cli_processes_shard_input(tmp_path, prepared):
    """``train-model --prepared-dir --stream-batches --shard-input --mesh`` on
    two processes (2 data x 1 model): each reads its own row groups; both
    ranks report the same run, the stream rung, and finite losses."""
    two = _cli_pair("twotower_tpu_torch.training.train",
                    ["--prepared-dir", str(prepared), "--stream-batches", "--shard-input",
                     "--shuffle-buffer", "512", "--checkpoint-dir", str(tmp_path / "ck"),
                     "--writers", "jsonl"], tmp_path / "store")
    assert two[0]["execution_rung"] == two[1]["execution_rung"] == "stream"
    assert two[0]["test"] == two[1]["test"] and np.isfinite(list(two[0]["test"].values())).all()
    recs = [json.loads(x) for x in (tmp_path / "ck" / "metrics.jsonl").read_text().splitlines()]
    assert [r for r in recs if "epoch" in r] and all(
        np.isfinite(r["loss"]) for r in recs if "epoch" in r)

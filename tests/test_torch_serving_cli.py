"""The port's ``serve-model`` (``python -m twotower_tpu_torch.serving.api``)
end to end on the CPU, as the JAX ``TestCliE2E::test_train_then_evaluate_then_serve``:
``train-model`` writes a checkpoint, ``evaluate-model`` scores its test
split, and ``serve-model`` (the ``tpu_mips_exact`` index, built by ``main``
from the checkpoint alone) answers the test users with the evaluation's own
search: the same ids, and the same scores (bit for bit from the index at the
evaluation's batch; to the response's 6 decimals over HTTP, where the
batcher's buckets change the product's row count)."""

import asyncio
import json

import numpy as np
import pytest
import torch

from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_cli import _common
from twotower_tpu_torch.config import load_config_for_checkpoint
from twotower_tpu_torch.evaluation import Evaluator
from twotower_tpu_torch.evaluation.evaluate import main as eval_main
from twotower_tpu_torch.models import two_tower
from twotower_tpu_torch.ops.topk import topk_mips_twopass
from twotower_tpu_torch.serving.api import build_service
from twotower_tpu_torch.serving.api import main as serve_main
from twotower_tpu_torch.training.train import main as train_main


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("serve") / "ckpt"
    assert train_main(_common(ckpt, "training.epochs=1") + ["--writers", "jsonl"]) == 0
    return ckpt


@pytest.fixture(scope="module")
def evaluated(trained):
    """evaluate-model's test users and its search's (scores, ids) for them,
    taken inside the Evaluator it builds."""
    seen = {}
    orig = Evaluator.evaluate

    def spy(self, params, user_idx, item_idx):
        with torch.no_grad():
            emb = two_tower.embed_users(params, torch.as_tensor(np.asarray(user_idx, np.int64)),
                                        self.config.model)
            vals, ids = topk_mips_twopass(emb, self._encode_corpus(params), self.max_k,
                                          chunk_size=self.corpus_chunk_size)
        seen.update(users=np.asarray(user_idx), vals=vals.numpy(), ids=ids.numpy(),
                    max_k=self.max_k)
        return orig(self, params, user_idx, item_idx)

    mp = pytest.MonkeyPatch()
    mp.setattr(Evaluator, "evaluate", spy)
    try:
        assert eval_main(_common(trained) + ["--subset", "test"]) == 0
    finally:
        mp.undo()
    assert len(seen["users"]) > 0
    return seen


def test_served_exact_index_equals_the_evaluation(trained, evaluated):
    cfg = load_config_for_checkpoint(trained, overrides={"serving.index_type": "tpu_mips_exact"})
    assert cfg.model.embedding_dim == 16  # the snapshot, not the defaults
    svc = build_service(cfg, str(trained), device="cpu")
    summary = json.loads((trained / "train_summary.json").read_text())
    assert svc.index.checkpoint_step == summary["best_step"]
    assert svc.index.corpus.dtype == torch.float32
    vals, ids = svc.index.recommend(evaluated["users"], evaluated["max_k"])
    np.testing.assert_array_equal(ids, evaluated["ids"])
    np.testing.assert_array_equal(vals, evaluated["vals"])
    out = svc.recommend({"user_idx": evaluated["users"][:5].tolist(), "k": 5})
    assert [r["item_idx"] for r in out["results"]] == evaluated["ids"][:5, :5].tolist()


def test_serve_model_cli_answers_with_the_evaluation(trained, evaluated, monkeypatch):
    """``main`` builds the app from the checkpoint (no model overrides
    re-passed); the coalesced /recommend answers every test user."""
    tu = pytest.importorskip("aiohttp.test_utils")
    from aiohttp import web

    apps = []
    monkeypatch.setattr(web, "run_app", lambda app, **kw: apps.append((app, kw)))
    assert serve_main(["--device", "cpu", "--checkpoint-dir", str(trained), "--port", "8123",
                       "--override", "serving.index_type=tpu_mips_exact"]) == 0
    (app, kw), = apps
    assert kw["port"] == 8123
    users, k = evaluated["users"], evaluated["max_k"]

    async def go():
        async with tu.TestClient(tu.TestServer(app)) as client:
            rs = await asyncio.gather(*(
                client.post("/recommend", json={"user_idx": users[s:s + 7].tolist(), "k": k})
                for s in range(0, len(users), 7)))
            assert all(r.status == 200 for r in rs)
            return [row for r in rs for row in (await r.json())["results"]]

    rows = asyncio.run(go())
    assert [r["user_idx"] for r in rows] == users.tolist()
    np.testing.assert_array_equal([r["item_idx"] for r in rows], evaluated["ids"])
    np.testing.assert_allclose([r["scores"] for r in rows], evaluated["vals"], rtol=0, atol=6e-7)


def test_serve_model_flags(trained, monkeypatch, capsys):
    import sys

    with pytest.raises(SystemExit) as e:
        serve_main(["--device", "cpu", "--checkpoint-dir", str(trained), "--shard-corpus"])
    assert e.value.code != 0 and "ROADMAP.md" in capsys.readouterr().err
    monkeypatch.setitem(sys.modules, "aiohttp", None)  # import raises ImportError
    with pytest.raises(SystemExit) as e:
        serve_main(["--device", "cpu", "--checkpoint-dir", str(trained)])
    assert e.value.code != 0 and "aiohttp" in capsys.readouterr().err

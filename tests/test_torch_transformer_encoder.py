"""The port's transformer text encoder against the JAX package's, on the CPU.

Offline, as ``tests/test_transformer_encoder.py``: a 13-word WordPiece
vocab written in the test and a 1-layer BERT (H=24, 2 heads, intermediate
32) built from a config with random weights, saved as Flax and carried to
torch with ``load_flax_weights_in_pytorch_model`` into the same directory,
so each package loads its own format of the same weights.

- ``encode`` / ``encode_per_item``: equal to JAX's arrays (the dedup, the
  +1 shift, truncation, the first-occurrence title rule).
- ``word_embedding_init``: equal to JAX's table bit for bit at E=8 (PCA),
  24 (equal widths) and 40 (zero pad), and at the default pad multiple.
- ``encode_vectors``: within rtol 1e-4 / atol 1e-5 of JAX's (torch's and
  Flax's layers sum in different orders) and independent of the batch size.
- ``init_train_state(text_embedding_init=)``, ``build_text_encoder``, the
  config's errors, and the module without ``transformers``.
- train-model with ``model.text_encoder=transformer``: its text buckets,
  pretrained init and ``item_tokens.npz`` equal the JAX CLI's, and
  evaluate-model reads its checkpoint back.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from twotower_tpu.features import transformer_encoder as jax_te  # noqa: E402
from twotower_tpu.training import train as jax_train  # noqa: E402
from twotower_tpu_torch.config import Config  # noqa: E402
from twotower_tpu_torch.features import transformer_encoder as te  # noqa: E402
from twotower_tpu_torch.features.text_encoder import HashedNgramEncoder  # noqa: E402
from twotower_tpu_torch.models import two_tower  # noqa: E402
from twotower_tpu_torch.training import init_train_state, make_optimizer  # noqa: E402
from twotower_tpu_torch.training import train as torch_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
VOCAB = [
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
    "hello", "world", "book", "##s", "great", "read", "a", "the",
]
TEXTS = np.array(
    ["hello world", "great read", "hello world", None, "", "the books",
     " ".join(["hello"] * 50), "a book", "great read"],
    dtype=object,
)
VEC_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory) -> str:
    """One random BERT in both formats: ``flax_model.msgpack`` for the JAX
    package, ``model.safetensors`` (the same weights) for the port."""
    from transformers.modeling_flax_pytorch_utils import load_flax_weights_in_pytorch_model

    d = tmp_path_factory.mktemp("tiny_bert")
    (d / "vocab.txt").write_text("\n".join(VOCAB))
    transformers.BertTokenizer(vocab_file=str(d / "vocab.txt")).save_pretrained(str(d))
    cfg = transformers.BertConfig(
        vocab_size=len(VOCAB), hidden_size=24, num_hidden_layers=1, num_attention_heads=2,
        intermediate_size=32, max_position_embeddings=64,
    )
    flax_model = transformers.FlaxBertModel(cfg, seed=0)
    flax_model.save_pretrained(str(d))
    model = transformers.BertModel(transformers.BertConfig.from_pretrained(str(d)))
    load_flax_weights_in_pytorch_model(model, flax_model.params)
    model.save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def encoders(model_dir):
    return (jax_te.TransformerTextEncoder(model_dir, max_tokens=8),
            te.TransformerTextEncoder(model_dir, max_tokens=8))


def test_encode_matches_jax(encoders):
    jenc, enc = encoders
    got = enc.encode(TEXTS)
    np.testing.assert_array_equal(got, jenc.encode(TEXTS))
    assert got.dtype == np.int32 and got.shape == (len(TEXTS), 8)
    assert (got[3] == 0).all() and (got[4] == 0).all()  # None and "" are all PAD
    assert (got[6] != 0).all()  # truncated to max_tokens
    np.testing.assert_array_equal(got[0], got[2])  # deduplicated texts
    # Real ids are shifted +1: 0 is PAD only, though [PAD] is the tokenizer's id 0.
    assert got[0, 0] == enc.tokenizer.cls_token_id + 1
    assert got.max() < enc.num_buckets == len(VOCAB) + 1


def test_encode_per_item_matches_jax(encoders):
    jenc, enc = encoders
    item_idx = np.array([1, 0, 1, 2, 5, 4, 4])
    texts = np.array(["great read", "hello", None, "", "a book", 0, "world"], dtype=object)
    titles = np.array(["book", None, "world", None, "the", None, ""], dtype=object)
    got = enc.encode_per_item(item_idx, texts, 6, titles=titles)
    np.testing.assert_array_equal(got, jenc.encode_per_item(item_idx, texts, 6, titles=titles))
    # Item 1 from row 0, title first; item 2 has no text; item 3 never appears.
    np.testing.assert_array_equal(got[1], enc.encode(np.array(["book great read"], object))[0])
    assert (got[2] == 0).all() and (got[3] == 0).all()
    # The same items have text as under the hashed encoder (one selection).
    hashed = HashedNgramEncoder(num_buckets=64, max_tokens=8).encode_per_item(
        item_idx, texts, 6, titles=titles)
    np.testing.assert_array_equal((hashed != 0).any(axis=1), (got != 0).any(axis=1))


@pytest.mark.parametrize("dim", [8, 24, 40], ids=["pca", "equal", "zero_pad"])
def test_word_embedding_init_matches_jax_bit_for_bit(encoders, dim):
    jenc, enc = encoders
    table = enc.word_embedding_init(dim, pad_multiple=8)
    np.testing.assert_array_equal(table, jenc.word_embedding_init(dim, pad_multiple=8))
    v = enc.tokenizer.vocab_size
    assert table.shape == (two_tower.padded_rows(enc.num_buckets, 8), dim)
    assert (table[0] == 0).all() and (table[v + 1:] == 0).all()
    rms = np.sqrt(np.mean(np.square(table[1:v + 1])))
    assert 0.5 / np.sqrt(dim) < rms < 2.0 / np.sqrt(dim)
    if dim > 24:
        assert (table[1:v + 1, 24:] == 0).all()


def test_word_embedding_init_default_pad_is_the_table_layout(encoders):
    jenc, enc = encoders
    table = enc.word_embedding_init(16)
    assert table.shape == (two_tower.padded_rows(enc.num_buckets), 16) == (two_tower.LANE, 16)
    np.testing.assert_array_equal(table, jenc.word_embedding_init(16))


class _Tok:
    """What ``_word_embeddings`` reads of a tokenizer: its two sizes."""

    def __init__(self, vocab_size, extra=0):
        self.vocab_size = vocab_size
        self.extra = extra

    def __len__(self):
        return self.vocab_size + self.extra


class _Embedder(torch.nn.Module):
    def __init__(self, rows_a, rows_b, hidden=6):
        super().__init__()
        self.head = torch.nn.Linear(hidden, rows_a, bias=False)  # weight [rows_a, hidden]
        self.tok_embed = torch.nn.Embedding(rows_b, hidden)


def test_word_embeddings_found_by_shape_then_name():
    tok = _Tok(5, extra=2)  # vocab_size 5, len 7 (resized for added tokens)
    # Both are [5, H]: the embedding-like name wins.
    enc = te.TransformerTextEncoder(tokenizer=tok, model=_Embedder(5, 5))
    np.testing.assert_array_equal(enc._word_embeddings(),
                                  enc._model.tok_embed.weight.detach().numpy())
    # The resized [len(tokenizer), H] match wins over an embedding-like name.
    enc = te.TransformerTextEncoder(tokenizer=tok, model=_Embedder(7, 5))
    np.testing.assert_array_equal(enc._word_embeddings(), enc._model.head.weight.detach().numpy())
    with pytest.raises(ValueError, match="embedding"):
        te.TransformerTextEncoder(tokenizer=tok, model=_Embedder(3, 4))._word_embeddings()
    with pytest.raises(ValueError, match="model_path or tokenizer"):
        te.TransformerTextEncoder()
    with pytest.raises(ValueError, match="no model given"):
        te.TransformerTextEncoder(tokenizer=tok).word_embedding_init(8)


def test_encode_vectors_match_jax_and_batch_size(encoders):
    jenc, enc = encoders
    texts = np.array(["hello world", "great read", "the books", "a book", "world", "", None],
                     dtype=object)
    ref = jenc.encode_vectors(texts, batch_size=4)
    enc._require_model().train()  # eval mode inside, the caller's mode restored after
    small = enc.encode_vectors(texts, batch_size=2, device="cpu")
    big = enc.encode_vectors(texts, batch_size=8, device="cpu")
    assert enc._model.training
    assert small.shape == (7, 24) and small.dtype == np.float32 and np.isfinite(small).all()
    np.testing.assert_allclose(small, ref, **VEC_TOL)
    np.testing.assert_allclose(small, big, **VEC_TOL)
    assert enc.encode_vectors(np.array([], dtype=object), device="cpu").shape == (0, 24)


def test_encode_vectors_defaults_to_the_gpu(encoders, monkeypatch):
    """``device=None`` is the GPU, never the host: with no GPU visible the
    path-loaded model is not run on the CPU unasked; asked for by name, the
    model is moved to that device and runs there."""
    _, enc = encoders
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    texts = np.array(["hello world", "great read"], dtype=object)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.encode_vectors(texts)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.encode_vectors(np.array([], dtype=object))
    moved = []
    model = enc._require_model()
    monkeypatch.setattr(model, "to", lambda dev: moved.append(dev) or model)
    assert enc.encode_vectors(texts, device="cpu").shape == (2, 24)
    assert moved == [torch.device("cpu")]


def test_init_train_state_takes_the_table(encoders):
    _, enc = encoders
    cfg = Config().with_overrides({
        "model.embedding_dim": 16, "model.user_tower_dims": [16], "model.item_tower_dims": [16],
        "model.text_buckets": enc.num_buckets})
    init = enc.word_embedding_init(16)
    opt = make_optimizer(cfg.training)
    state = init_train_state(cfg, opt, 20, 10, text_embedding_init=init, device="cpu")
    np.testing.assert_array_equal(state.params["text_embedding"].numpy(), init)
    with pytest.raises(ValueError, match="text_embedding_init"):
        init_train_state(cfg, opt, 20, 10, text_embedding_init=np.zeros((3, 3), np.float32),
                         device="cpu")


def test_build_text_encoder_and_config_errors(model_dir):
    cfg = Config().with_overrides({"model.embedding_dim": 16})
    assert te.build_text_encoder(cfg.model) is None
    hashed = te.build_text_encoder(cfg.with_overrides({"model.text_buckets": 64}).model)
    assert isinstance(hashed, HashedNgramEncoder) and hashed.num_buckets == 64
    enc = te.build_text_encoder(cfg.with_overrides({
        "model.text_encoder": "transformer", "model.text_model_path": model_dir,
        "model.text_tokens": 8}).model)
    assert isinstance(enc, te.TransformerTextEncoder)
    assert (enc.num_buckets, enc.max_tokens) == (len(VOCAB) + 1, 8)
    with pytest.raises(ValueError, match="text_model_path"):
        cfg.with_overrides({"model.text_encoder": "transformer"})
    with pytest.raises(ValueError, match="text_encoder"):
        cfg.with_overrides({"model.text_encoder": "bert"})


def test_resolve_without_weights_keeps_random_init_as_jax(tmp_path):
    """A directory with a tokenizer and no weights: buckets resolve, the
    model load fails (OSError) and the text table keeps its random init,
    as in the JAX CLI."""
    (tmp_path / "vocab.txt").write_text("\n".join(VOCAB))
    transformers.BertTokenizer(vocab_file=str(tmp_path / "vocab.txt")).save_pretrained(
        str(tmp_path))
    over = {"model.text_encoder": "transformer", "model.text_model_path": str(tmp_path),
            "model.text_tokens": 8}
    cfg, enc, init = torch_train._resolve_text_tower(Config().with_overrides(over), True)
    from twotower_tpu.config import Config as JaxConfig

    jcfg, _, jinit = jax_train._resolve_text_tower(None, JaxConfig().with_overrides(over), True)
    assert init is None and jinit is None
    assert cfg.model.text_buckets == jcfg.model.text_buckets == len(VOCAB) + 1
    assert torch_train._resolve_text_tower(cfg, False) == (cfg, None, None)


def test_module_needs_no_transformers_for_handed_in_objects():
    code = (
        "import sys\n"
        "sys.modules['transformers'] = None\n"
        "import numpy as np\n"
        "from twotower_tpu_torch.features.transformer_encoder import TransformerTextEncoder\n"
        "class Tok:\n"
        "    cls_token_id = 1\n"
        "    vocab_size = 5\n"
        "    def __len__(self): return 5\n"
        "    def __call__(self, texts, truncation, max_length, padding, return_attention_mask):\n"
        "        rows = [[1, *[3] * len(t.split()), 2][:max_length] for t in texts]\n"
        "        return {'input_ids': [r + [0] * (max_length - len(r)) for r in rows],\n"
        "                'attention_mask': [[1] * len(r) + [0] * (max_length - len(r))"
        " for r in rows]}\n"
        "enc = TransformerTextEncoder(tokenizer=Tok(), max_tokens=4)\n"
        "print(enc.encode(np.array(['a b', '', 'a b c d'], dtype=object)).tolist())\n"
        "try:\n"
        "    TransformerTextEncoder('some/dir')\n"
        "except ImportError:\n"
        "    print('loading a model_path needs transformers')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout.splitlines()
    assert out == ["[[2, 4, 4, 3], [0, 0, 0, 0], [2, 4, 4, 4]]",
                   "loading a model_path needs transformers"]


CLI_DATA = ["--synthetic", "--synthetic-users", "60", "--synthetic-items", "40",
            "--synthetic-interactions", "2000"]


def _spy_resolve(monkeypatch, module, into: list):
    orig = module._resolve_text_tower

    def spy(*args):
        out = orig(*args)
        into.append(out)
        return out

    monkeypatch.setattr(module, "_resolve_text_tower", spy)


def test_train_cli_with_transformer_matches_jax_and_evaluates(model_dir, tmp_path, monkeypatch,
                                                              capsys):
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main

    overrides = [
        "--override", "training.epochs=1", "training.batch_size=32", "model.embedding_dim=16",
        "model.user_tower_dims=[16]", "model.item_tower_dims=[16]",
        "model.text_encoder=transformer", f"model.text_model_path={model_dir}",
        "model.text_tokens=8", "preprocessing.min_interactions_per_user=2",
        "preprocessing.min_interactions_per_item=2",
    ]
    seen, jseen = [], []
    _spy_resolve(monkeypatch, torch_train, seen)
    _spy_resolve(monkeypatch, jax_train, jseen)
    ckpt, jckpt = tmp_path / "torch", tmp_path / "jax"
    assert torch_train.main([*CLI_DATA, "--synthetic-text", "--device", "cpu", "--checkpoint-dir",
                             str(ckpt), "--writers", "jsonl", *overrides]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_train.main([*CLI_DATA, "--synthetic-text", "--no-eval", "--checkpoint-dir",
                           str(jckpt), "--writers", "jsonl", *overrides]) == 0
    for d in (ckpt, jckpt):
        assert json.loads((d / "config.json").read_text())["model"]["text_buckets"] == 14
    (_, enc, init), (_, _, jinit) = seen[0], jseen[0]
    assert isinstance(enc, te.TransformerTextEncoder)
    assert init.shape == (two_tower.padded_rows(14), 16)
    np.testing.assert_array_equal(init, jinit)
    with np.load(ckpt / "item_tokens.npz") as f, np.load(jckpt / "item_tokens.npz") as g:
        np.testing.assert_array_equal(f["tokens"], g["tokens"])
        assert f["tokens"].shape == (summary["num_items"], 8)
    capsys.readouterr()
    assert eval_main([*CLI_DATA, "--device", "cpu", "--checkpoint-dir", str(ckpt),
                      "--subset", "test"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["checkpoint_step"] == summary["best_step"]
    assert all(np.isfinite(v) for v in ev["metrics"].values())

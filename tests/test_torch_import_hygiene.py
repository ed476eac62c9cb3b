"""The PyTorch port stands alone: no module of ``twotower_tpu_torch/`` and
not ``chip_smoke.py`` imports JAX, its libraries or the JAX package; and
its entry points run on the GPU unless the caller asks for the CPU by name
(with no GPU they raise instead of falling back).

Also the tests that need the card, marked ``cuda`` and skipped where no GPU
is visible: the CUDA kernels against their plain versions, and device-loop
epochs (the sparse step, the dense step, the text tower) captured as a CUDA
graph against the same epochs eager. This file
imports no JAX, so it runs on a GPU machine that has none."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from twotower_tpu_torch.config import Config
from twotower_tpu_torch.training import init_train_state, make_optimizer, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "twotower_tpu"}
HTTP = {"aiohttp", "fastapi"}
PORT_FILES = sorted((ROOT / "twotower_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path, *, module_level: bool = False) -> set[str]:
    """Root packages ``path`` imports anywhere, or only in its top-level
    statements (those run at import)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in tree.body if module_level else ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert not _imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_http_package_at_module_level(path):
    assert not _imported_roots(path, module_level=True) & HTTP


def test_hygiene_check_sees_the_whole_package():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "twotower_tpu_torch/ops/kernels.py",
            "twotower_tpu_torch/training/sparse.py",
            "twotower_tpu_torch/data/pipeline.py",
            "twotower_tpu_torch/evaluation/evaluator.py",
            "twotower_tpu_torch/utils/checkpoint.py",
            "twotower_tpu_torch/ops/topk.py",
            "twotower_tpu_torch/serving/index.py",
            "twotower_tpu_torch/serving/api.py",
            "twotower_tpu_torch/training/device_loop.py",
            "twotower_tpu_torch/training/rungs.py",
            "twotower_tpu_torch/data/prepared.py",
            "twotower_tpu_torch/data/streaming.py",
            "twotower_tpu_torch/data/prepare.py",
            "twotower_tpu_torch/features/engineer.py",
            "twotower_tpu_torch/data/synthetic_scale.py",
            "twotower_tpu_torch/evaluation/oracle.py",
            "twotower_tpu_torch/tools/oracle_parity.py",
            "twotower_tpu_torch/tools/oracle_variants.py",
            "twotower_tpu_torch/features/text_encoder.py",
            "twotower_tpu_torch/features/transformer_encoder.py",
            "twotower_tpu_torch/serving/cpu_index.py",
            "twotower_tpu_torch/data/amazon.py",
            "twotower_tpu_torch/data/download.py",
            "twotower_tpu_torch/data/explore.py",
            "twotower_tpu_torch/data/orchestrate.py",
            "twotower_tpu_torch/data/migrate.py",
            "twotower_tpu_torch/parallel/mesh.py",
            "twotower_tpu_torch/parallel/sharding.py",
            "twotower_tpu_torch/parallel/a2a.py",
            "twotower_tpu_torch/parallel/spmd.py",
            "twotower_tpu_torch/parallel/sparse_spmd.py",
            "twotower_tpu_torch/bridge.py"} <= names


def test_parallel_picks_its_backend_from_the_device_never_from_an_exception():
    """``parallel/*`` chooses ``nccl`` or ``gloo`` by the device (and stages a
    gloo collective on CUDA tensors by name): no module of it catches an
    exception, so no failure can quietly pick another backend or path."""
    files = sorted((ROOT / "twotower_tpu_torch" / "parallel").glob("*.py"))
    assert len(files) >= 6
    for path in files:
        tree = ast.parse(path.read_text())
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)], path.name
    mesh = (ROOT / "twotower_tpu_torch" / "parallel" / "mesh.py").read_text()
    assert 'BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}' in mesh


# Packages the port uses only where it needs them (loading a HF model
# directory, fetching from the Hub, charts): never imported at module level,
# so the port imports on a machine without them (the H100 machine has none).
OPTIONAL = {"transformers", "datasets", "huggingface_hub", "matplotlib"}


def test_optional_packages_are_imported_lazily():
    eager = {p.relative_to(ROOT).as_posix(): _imported_roots(p, module_level=True) & OPTIONAL
             for p in PORT_FILES}
    assert not {k: v for k, v in eager.items() if v}
    lazy = {p.name for p in PORT_FILES if _imported_roots(p) & OPTIONAL}
    assert {"transformer_encoder.py", "amazon.py", "explore.py"} <= lazy


def test_cpu_index_builds_the_ports_own_source():
    """``serving/cpu_index.py`` compiles ``twotower_tpu_torch/native/flat_index.cpp``
    (its own copy, shipped as package data), not the JAX package's."""
    from twotower_tpu_torch.serving import cpu_index

    assert cpu_index.SRC == ROOT / "twotower_tpu_torch" / "native" / "flat_index.cpp"
    assert cpu_index.SRC.exists() and "extern \"C\"" in cpu_index.SRC.read_text()
    assert cpu_index.library_path().parent == ROOT / "build" / "native"
    assert '"twotower_tpu_torch.native" = ["*.cpp"]' in (ROOT / "pyproject.toml").read_text()


def test_roadmap_citations_name_queue_1_items():
    """No port module says that a part is "not ported yet", and none cites an
    item of ROADMAP.md's Queue 1 that is still open (its "Still to port"
    list): every part of the JAX package has its twin. A citation, where
    one remains, names a bold item of the queue."""
    import re

    texts = {p.relative_to(ROOT).as_posix(): p.read_text() for p in PORT_FILES}
    assert not [name for name, text in texts.items() if "not ported yet" in text.lower()]
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    items = {m.strip(" .:").lower() for m in re.findall(r"\*\*([^*]+)\*\*", queue)}
    still = queue[queue.index("Still to port"):] if "Still to port" in queue else ""
    open_items = {m.strip(" .:").lower() for m in re.findall(r"\*\*([^*]+)\*\*", still)}
    cited = {m.strip().lower() for text in texts.values()
             for m in re.findall(r"ROADMAP\.md, Queue 1: ([\w -]+)", text)}
    assert all(any(i.startswith(c) for i in items) for c in cited), (cited, items)
    assert not {c for c in cited if any(i.startswith(c) for i in open_items)}, (cited, open_items)


def _small():
    return Config().with_overrides(
        {"model.embedding_dim": 16, "model.user_tower_dims": [16],
         "model.item_tower_dims": [16]}
    )


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    cfg = _small()
    opt = make_optimizer(cfg.training)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, opt, 10, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg, opt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, opt, 10, 10, device="cuda")
    state = init_train_state(cfg, opt, 10, 10, device="cpu")
    assert state.params["user_embedding"].device.type == "cpu"


def test_trainer_evaluator_and_clis_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from twotower_tpu_torch.evaluation import Evaluator
    from twotower_tpu_torch.evaluation.evaluate import main as eval_main
    from twotower_tpu_torch.training import Trainer
    from twotower_tpu_torch.training.device_loop import DeviceTrainer, make_epoch_fn
    from twotower_tpu_torch.training.train import main as train_main

    cfg = _small()
    opt = make_optimizer(cfg.training)
    for make in (lambda: Trainer(cfg), lambda: Evaluator(cfg, 10), lambda: DeviceTrainer(cfg),
                 lambda: make_epoch_fn(cfg, opt, 3),
                 lambda: train_main(["--synthetic", "--checkpoint-dir", str(tmp_path)]),
                 lambda: train_main(["--synthetic", "--checkpoint-dir", str(tmp_path),
                                     "--exec", "device-loop"]),
                 lambda: eval_main(["--synthetic", "--checkpoint-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert Trainer(cfg, device="cpu").device.type == "cpu"
    assert Evaluator(cfg, 10, device="cpu").device.type == "cpu"
    assert not any(tmp_path.iterdir())  # the CLIs raised before any work


def test_serving_defaults_to_cuda_and_raises_without_it(no_cuda, tmp_path):
    from twotower_tpu_torch.models import two_tower
    from twotower_tpu_torch.serving import RetrievalIndex
    from twotower_tpu_torch.serving.api import build_service
    from twotower_tpu_torch.serving.api import main as serve_main

    cfg = _small()
    params = two_tower.init_params(torch.Generator().manual_seed(0), cfg.model, 10, 10)
    for make in (lambda: RetrievalIndex(cfg, params, 10, 10),
                 lambda: RetrievalIndex.from_checkpoint(cfg, tmp_path),
                 lambda: build_service(cfg, str(tmp_path)),
                 lambda: serve_main(["--checkpoint-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert RetrievalIndex(cfg, params, 10, 10, device="cpu").corpus.device.type == "cpu"
    assert not any(tmp_path.iterdir())


def test_oracle_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    """The generator (unless ``--no-device``), the oracle CLI, the parity
    and variants tools and the ranks all run on the card unless ``--device cpu`` or
    ``device="cpu"`` is given; without a GPU they raise before any work,
    and the device sampler has no fallback to numpy."""
    from twotower_tpu_torch.data import synthetic_scale
    from twotower_tpu_torch.evaluation import oracle
    from twotower_tpu_torch.tools import oracle_parity, oracle_variants

    gen = ["--output-dir", str(tmp_path / "gen"), "--interactions", "2000", "--users", "50",
           "--items", "100", "--clusters", "4", "--latent-dim", "4", "--oracle"]
    ranks = (lambda u: np.zeros((len(u), 2), np.float32), np.zeros(5, np.int32),
             np.zeros(5, np.float32), np.arange(3), np.arange(3))
    for make in (lambda: synthetic_scale.main(gen),
                 lambda: synthetic_scale.generate_parquet(tmp_path / "g2", num_interactions=100,
                                                          num_users=10, num_items=20,
                                                          num_clusters=4, use_device=True),
                 lambda: oracle.main(["--teacher", str(tmp_path / "t.npz"),
                                      "--prepared-dir", str(tmp_path)]),
                 lambda: oracle._structured_ranks(*ranks),
                 lambda: oracle_parity.main(["--scale", "smoke",
                                             "--work-dir", str(tmp_path / "w")]),
                 lambda: oracle_variants.main(["--scale", "smoke",
                                               "--work-dir", str(tmp_path / "v")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not any(tmp_path.iterdir())  # each raised before any work
    assert list(oracle._structured_ranks(*ranks, device="cpu")) == [0, 1, 2]  # all tied
    assert synthetic_scale.main(gen + ["--no-device"]) == 0
    assert synthetic_scale.main(gen + ["--device", "cpu", "--output-dir",
                                       str(tmp_path / "cpu")]) == 0


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch,dim,rows,off",
    [(4096, 128, 4096, 0), (1000, 96, 300, 500), (4097, 128, 4097, 0), (1000, 20, 1000, 0),
     (600, 30, 600, 0), (512, 256, 512, 0)],
)
def test_cuda_kernels_match_plain(cuda_device, batch, dim, rows, off):
    from twotower_tpu_torch.ops import kernels

    # Inputs at the training step's scale: unit-norm tower outputs at
    # temperature 0.1 (logits in [-10, 10]) and g = weight / denominator.
    # test_pallas.py's tolerances are for that scale; with raw N(0, 1) rows
    # the logits reach ~100 and the float32 summation order of S alone
    # moves the sharp softmax by more than atol.
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    u = torch.tensor(rng.normal(size=(rows, dim)), dtype=torch.float32, device=cuda_device)
    v = torch.tensor(rng.normal(size=(batch, dim)), dtype=torch.float32, device=cuda_device)
    u = u / u.norm(dim=1, keepdim=True)
    v = v / v.norm(dim=1, keepdim=True)
    ids = torch.tensor(rng.integers(0, batch // 2, batch), dtype=torch.int32, device=cuda_device)
    w = torch.ones(batch, device=cuda_device)
    w[-7:] = 0.0
    lq = torch.tensor(np.log(rng.uniform(1e-4, 1e-2, batch // 2)), dtype=torch.float32,
                      device=cuda_device)
    cols = kernels.logq_cols(ids, lq, w)
    g = torch.rand(rows, device=cuda_device) / rows
    args = (u, v, ids, cols, off)
    got = kernels.fused_fwd(*args, 10.0)
    ref = kernels.fwd_plain(*args, 10.0)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    lse = ref[1]
    du = kernels.fused_bwd_du(*args, lse, g, 10.0)
    dv = kernels.fused_bwd_dv(*args, lse, g, 10.0)
    torch.testing.assert_close(du, kernels.bwd_du_plain(*args, lse, g, 10.0), rtol=5e-3, atol=1e-5)
    torch.testing.assert_close(dv, kernels.bwd_dv_plain(*args, lse, g, 10.0), rtol=5e-3, atol=1e-5)
    # Deterministic: the slices' partial results are merged in a fixed order.
    for a, b in zip(got, kernels.fused_fwd(*args, 10.0)):
        assert torch.equal(a, b)
    assert torch.equal(du, kernels.fused_bwd_du(*args, lse, g, 10.0))
    assert torch.equal(dv, kernels.fused_bwd_dv(*args, lse, g, 10.0))


@pytest.mark.cuda
def test_device_loop_graph_matches_eager(cuda_device):
    """One epoch with the step captured as a CUDA graph and replayed, against
    the same epoch eager on the card, from one state and one permutation
    (schedule on, dropout 0): metrics rtol 1e-4, state rtol 1e-4 / atol
    1e-5; each kernel's launches equal the steps under replay."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config().with_overrides(
        {"model.embedding_dim": 32, "model.user_tower_dims": [64, 32],
         "model.item_tower_dims": [64, 32], "model.compute_dtype": "float32",
         "model.dropout_rate": 0.0, "training.batch_size": 256,
         "training.warmup_steps": 3, "training.decay_steps": 10}
    )
    start = bridge.state_to_numpy(
        init_train_state(cfg, make_optimizer(cfg.training), 1000, 500, device="cpu"))
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 1000, 256 * 9), rng.integers(0, 500, 256 * 9)
    perm = rng.permutation(256 * 9)
    out = {}
    for capture in (True, False):
        state = bridge.state_from_numpy(start, device=cuda_device)
        ds = DeviceDataset(users, items, 256, device=cuda_device)
        fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, device=cuda_device,
                           capture=capture)
        kernels.reset_launch_counts()
        state, m = fn(state, ds.columns, 0, perm=perm)
        out[capture] = ({k: float(v) for k, v in m.items()}, bridge.state_to_numpy(state),
                        [w.launches for w in kernels.WRAPPERS])
    assert out[True][2] == out[False][2] == [9, 9, 9]
    for k, v in out[False][0].items():
        np.testing.assert_allclose(out[True][0][k], v, rtol=1e-4, err_msg=k)
    for name in ("user_embedding", "item_embedding"):
        np.testing.assert_allclose(out[True][1]["params"][name], out[False][1]["params"][name],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense", "text"])
def test_dense_and_text_graph_matches_eager(cuda_device, path):
    """A device-loop epoch of the dense step (adamw, weight decay, schedule)
    or of the sparse step with item tokens, captured and replayed against
    the same epoch eager on the card (dropout 0): metrics rtol 1e-4, state
    rtol 1e-4 / atol 1e-5; each kernel launches once a step."""
    from twotower_tpu_torch import bridge
    from twotower_tpu_torch.ops import kernels
    from twotower_tpu_torch.training.device_loop import DeviceDataset, make_epoch_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    over = {"model.embedding_dim": 32, "model.user_tower_dims": [64, 32],
            "model.item_tower_dims": [64, 32], "model.compute_dtype": "float32",
            "model.dropout_rate": 0.0, "training.batch_size": 256,
            "training.warmup_steps": 3, "training.decay_steps": 10}
    if path == "dense":
        over.update({"training.optimizer": "adamw", "training.weight_decay": 0.01})
    else:
        over.update({"model.text_buckets": 512, "model.text_tokens": 8})
    cfg = Config().with_overrides(over)
    start = bridge.state_to_numpy(
        init_train_state(cfg, make_optimizer(cfg.training), 1000, 500, device="cpu"))
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 1000, 256 * 9), rng.integers(0, 500, 256 * 9)
    tokens = rng.integers(0, 512, (500, 8)).astype(np.int32) if path == "text" else None
    perm = rng.permutation(256 * 9)
    out = {}
    for capture in (True, False):
        state = bridge.state_from_numpy(start, device=cuda_device)
        ds = DeviceDataset(users, items, 256, device=cuda_device)
        fn = make_epoch_fn(cfg, make_optimizer(cfg.training), ds.num_steps, device=cuda_device,
                           capture=capture)
        tok = None if tokens is None else torch.as_tensor(tokens, device=cuda_device)
        kernels.reset_launch_counts()
        state, m = fn(state, ds.columns, 0, None, tok, perm=perm)
        out[capture] = ({k: float(v) for k, v in m.items()}, bridge.state_to_numpy(state),
                        [w.launches for w in kernels.WRAPPERS])
    assert out[True][2] == out[False][2] == [9, 9, 9]
    for k, v in out[False][0].items():
        np.testing.assert_allclose(out[True][0][k], v, rtol=1e-4, err_msg=k)
    for part in ("params", "opt_state", "table_state"):
        graph, eager = out[True][1][part], out[False][1][part]
        if eager is None:
            assert graph is None
            continue
        for x, y in zip(_leaves(graph), _leaves(eager)):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-5, err_msg=part)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, np.ndarray) else []

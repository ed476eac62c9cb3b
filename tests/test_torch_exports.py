"""The port's packages export what the JAX package's export: every name of
each JAX ``__all__`` resolves on the port's twin package, less
``parallel.batch_shardings`` and ``parallel.state_shardings`` (JAX
``NamedSharding`` builders, whose place the port's ``StateSharding`` takes).
``models.param_count`` equals JAX's on the same config; importing ``ops``
builds and loads no kernel."""

import importlib
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from twotower_tpu.config import Config as JaxConfig
from twotower_tpu.models import two_tower as jtt
from twotower_tpu_torch.config import Config
from twotower_tpu_torch.models import param_count

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ["", "models", "ops", "training", "utils", "parallel", "serving", "evaluation",
            "data", "features"]
JAX_ONLY = {"parallel": {"batch_shardings", "state_shardings"}}


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_every_jax_export_resolves_on_the_port(package):
    suffix = f".{package}" if package else ""
    ref = importlib.import_module(f"twotower_tpu{suffix}")
    port = importlib.import_module(f"twotower_tpu_torch{suffix}")
    names = set(ref.__all__) - JAX_ONLY.get(package, set())
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing
    assert names <= set(port.__all__)


@pytest.mark.parametrize("text_buckets", [0, 300])
def test_param_count_matches_jax(text_buckets):
    over = {"model.embedding_dim": 16, "model.user_tower_dims": [32, 16],
            "model.item_tower_dims": [24, 16], "model.text_buckets": text_buckets}
    jparams = jtt.init_params(jax.random.PRNGKey(0), JaxConfig().with_overrides(over).model,
                              70, 50)
    params = Config().with_overrides(over)
    from twotower_tpu_torch.models import two_tower

    ours = two_tower.init_params(torch.Generator().manual_seed(0), params.model, 70, 50)
    assert param_count(ours) == jtt.param_count(jparams) > 0


def test_importing_ops_builds_no_kernel():
    """The search imports the kernel machinery (``ops/build.py``) with the
    package, but nothing is built or loaded until a kernel's first launch,
    and the fused loss's wrappers are not imported at all."""
    code = ("import sys, twotower_tpu_torch.ops as ops; "
            "from twotower_tpu_torch.ops import build, prefilter; "
            "print(ops.topk_mips.__module__, 'twotower_tpu_torch.ops.kernels' in sys.modules, "
            "len(build.build_logs), prefilter._lib.cache_info().currsize, "
            "any('torch_kernels' in line for line in open('/proc/self/maps')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["twotower_tpu_torch.ops.topk", "False", "0", "0", "False"]

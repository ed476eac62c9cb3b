"""The port's mesh (``parallel/mesh.py``): the rank layout against the JAX
package's device grid, the four collectives along each axis on gloo ranks
on the CPU, the backend chosen by device (never by a failure), the
host-locality refusal, and ``--mesh`` as a world of one process."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from test_torch_bridge import one_torch_thread  # noqa: F401  (autouse fixture)
from torch_mesh_jax import LAYOUTS, layout_id
from torch_mesh_ranks import run_ranks
from twotower_tpu_torch.config import MeshConfig
from twotower_tpu_torch.parallel import mesh as port_mesh

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("layout", LAYOUTS, ids=layout_id)
def test_axes_and_collectives(tmp_path, layout):
    """Rank ``d*S + m`` sits at JAX's grid position ``(d, m)``; each axis
    groups the ranks JAX's mesh groups, and all-reduce, all-gather,
    all-to-all and reduce-scatter along it give what numpy does; the
    all-gather's backward reduce-scatters the cotangents."""
    from twotower_tpu.config import MeshConfig as JaxMeshConfig
    from twotower_tpu.parallel import build_mesh

    d, s = layout
    world = d * s
    jmesh = build_mesh(JaxMeshConfig(num_model=s), jax.devices()[:world])
    grid = np.array([[dev.id for dev in row] for row in jmesh.devices])
    out = run_ranks(workers.collectives, world, tmp_path, {"num_model": s})
    members = {"data": lambda r: [m for m in range(world) if m % s == r % s],
               "model": lambda r: [m for m in range(world) if m // s == r // s],
               "combined": lambda r: list(range(world))}
    for r, got in enumerate(out):
        assert (int(got["mesh/d"]), int(got["mesh/m"])) == (r // s, r % s)
        assert grid[r // s, r % s] == jax.devices()[r].id
        assert str(got["mesh/backend"]) == "gloo"
        for name, of in members.items():
            group = of(r)
            n = len(group)
            assert int(got[f"{name}/size"]) == n and int(got[f"{name}/index"]) == group.index(r)
            xs = [np.arange(2 * n, dtype=np.float32) + 100 * q for q in group]
            np.testing.assert_array_equal(got[f"{name}/all_reduce"], sum(xs))
            np.testing.assert_array_equal(got[f"{name}/all_gather"], np.concatenate(xs))
            i = group.index(r)
            np.testing.assert_array_equal(got[f"{name}/all_to_all"],
                                          np.concatenate([x[2 * i:2 * i + 2] for x in xs]))
            np.testing.assert_array_equal(got[f"{name}/reduce_scatter"],
                                          sum(xs)[2 * i:2 * i + 2])
            # d/dg of sum(gathered * row index) summed over the group's ranks.
            np.testing.assert_array_equal(got[f"{name}/grad"],
                                          n * np.arange(3 * i, 3 * i + 3)[:, None].repeat(2, 1))


def test_backend_follows_the_device():
    assert port_mesh.default_backend("cuda") == "nccl"
    assert port_mesh.default_backend(torch.device("cpu")) == "gloo"


def test_model_groups_must_stay_on_one_host(caplog):
    """The JAX ``build_mesh`` refusal (``tests/test_mesh_topology.py``): a
    model group spanning hosts raises unless ``allow_dcn_model_axis``."""
    hosts = ["a", "a", "b", "b"]
    port_mesh.check_model_groups_on_hosts(MeshConfig(num_model=2), hosts, 2)
    port_mesh.check_model_groups_on_hosts(MeshConfig(num_model=1), hosts, 1)
    with pytest.raises(ValueError, match="cross hosts"):
        port_mesh.check_model_groups_on_hosts(MeshConfig(num_model=4), hosts, 4)
    with pytest.raises(ValueError, match="cross hosts"):
        port_mesh.check_model_groups_on_hosts(MeshConfig(num_model=2), ["a", "b", "a", "b"], 2)
    port_mesh.check_model_groups_on_hosts(MeshConfig(num_model=4, allow_dcn_model_axis=True),
                                          hosts, 4)
    assert "allow_dcn_model_axis=true" in caplog.text


def test_mesh_flag_alone_is_a_world_of_one(tmp_path):
    """``train-model --mesh`` with no launcher and no ``--coordinator`` runs
    the mesh code over one process and says so."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-m", "twotower_tpu_torch.training.train", "--device", "cpu", "--mesh",
         "--synthetic", "--synthetic-users", "100", "--synthetic-items", "60",
         "--synthetic-interactions", "2000", "--checkpoint-dir", str(tmp_path), "--writers",
         "jsonl", "--override", "training.epochs=1", "training.batch_size=32",
         "model.embedding_dim=8", "model.user_tower_dims=[16,8]",
         "model.item_tower_dims=[16,8]"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["mesh"] == {"data": 1, "model": 1, "rank": 0, "backend": "gloo"}
    assert "a world of one process" in out.stderr
    assert "sparse mesh step" in out.stderr

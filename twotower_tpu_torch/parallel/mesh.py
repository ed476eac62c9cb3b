"""The ``(data, model)`` mesh over ``torch.distributed`` ranks, and the
collectives the mesh paths use.

Counterpart of ``twotower_tpu/parallel/mesh.py``. JAX runs one controller
over a device mesh; PyTorch runs one process a rank. The mesh here is this
process's view of it:

- ``data``: the batch axis; ``model``: the row-sharding axis of the
  embedding tables and of the evaluation corpus. Ranks are ordered
  data-major (``rank = d * num_model + m``), so global table row ``g`` of a
  table sharded over both axes lives on rank ``g // rows_per_shard``, as
  ``P((data, model), None)`` places it in JAX.
- The groups come from ``init_device_mesh`` with the mesh's axis names; the
  combined axis is the world group.
- The backend follows the device, never a failure: ``nccl`` on ``cuda``,
  ``gloo`` on ``cpu``. ``build_mesh(backend=...)`` may name another, and
  ``gloo`` with CUDA tensors is the one such pair the port runs (two ranks
  sharing one card). Gloo runs all four collectives the port uses on CUDA
  tensors itself (``chip_smoke.py`` phase 10a checks each on the card);
  such a mesh cannot be captured in a CUDA graph.
- The model groups must not cross hosts (the table all-to-all would leave
  the host's NVLink), unless ``mesh.allow_dcn_model_axis`` is set: the same
  loud refusal the JAX ``build_mesh`` makes.

``--mesh`` with no launcher's environment (``RANK``/``WORLD_SIZE``/
``MASTER_ADDR``) and no ``--coordinator`` is a world of one process, the
twin of JAX's mesh over the visible devices of a one-card machine: it runs
the mesh code, collectives included, and says so.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from twotower_tpu_torch.config import MeshConfig
from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.utils.platform import resolve_device

logger = get_logger(__name__)

# The backend of each device type.
BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}
def default_backend(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return BACKEND_OF_DEVICE[torch.device(device).type]


class Axis:
    """One axis of the mesh (``data``, ``model``, or both combined): its
    process group, its size and this rank's index on it, and the four
    collectives along it. Each returns a new tensor; a group of one rank
    still runs its collective."""

    def __init__(self, name: str, group: Any, size: int, index: int):
        self.name = name
        self.group = group
        self.size = size
        self.index = index

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis."""
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The axis's tensors concatenated along dim 0, in axis order."""
        t = t.detach().contiguous()
        out = t.new_empty((self.size * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Dim 0 cut in ``size`` equal chunks, chunk ``j`` sent to index ``j``;
        the result holds, at chunk ``i``, what index ``i`` sent here."""
        t = t.detach().contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis, of which this rank keeps chunk ``index`` of
        dim 0 (the transpose of ``all_gather``)."""
        t = t.detach().contiguous()
        out = t.new_empty((t.shape[0] // self.size, *t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=self.group)
        return out


class _AllGather(torch.autograd.Function):
    """All-gather along an axis whose backward reduce-scatters the
    cotangents back to their owners (JAX's transpose of ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, axis: Axis):
        ctx.axis = axis
        return axis.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.reduce_scatter(g), None


def all_gather_grad(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``axis.all_gather`` that autograd differentiates."""
    return _AllGather.apply(x, axis)


@dataclass
class Mesh:
    """This rank's view of the ``(data, model)`` mesh."""

    config: MeshConfig
    num_data: int
    num_model: int
    rank: int
    device: torch.device
    backend: str
    device_mesh: Any
    data: Axis
    model: Axis
    combined: Axis

    @property
    def world(self) -> int:
        return self.num_data * self.num_model

    @property
    def d_idx(self) -> int:
        return self.rank // self.num_model

    @property
    def m_idx(self) -> int:
        return self.rank % self.num_model

    def axis(self, name: str) -> Axis:
        """``data``, ``model`` or ``combined``."""
        return {"data": self.data, "model": self.model, "combined": self.combined}[name]


def _env_world() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str,
) -> bool:
    """Join the process group (the counterpart of ``jax.distributed.
    initialize``): ``--coordinator host:port`` with ``--num-processes`` and
    ``--process-id`` gives ``init_process_group(init_method="tcp://...")``
    (a coordinator that is already a URL, such as ``file:///path``, is
    taken as it is);
    a launcher's environment (``torchrun``: ``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``) gives ``env://``; neither gives a world of one process
    over an in-process store. A no-op once the group exists. Returns
    whether this call created the group (its caller then destroys it)."""
    if dist.is_initialized():
        return False
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and --process-id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url, world_size=num_processes,
                                rank=process_id)
    elif _env_world():
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
        logger.info("mesh: no launcher and no --coordinator: a world of one process")
    return True


def _rank_device(dev: torch.device, rank: int) -> torch.device:
    """This rank's card: ``LOCAL_RANK`` where a launcher sets it, else the
    rank modulo the visible cards."""
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def check_model_groups_on_hosts(config: MeshConfig, hosts: list[str], num_model: int) -> None:
    """Refuse a model group (ranks ``d*S .. d*S+S-1``) that spans hosts,
    unless ``mesh.allow_dcn_model_axis``."""
    spans = [sorted(set(hosts[g * num_model:(g + 1) * num_model]))
             for g in range(len(hosts) // num_model)]
    bad = [s for s in spans if len(s) > 1]
    if not bad:
        return
    counts = {h: hosts.count(h) for h in sorted(set(hosts))}
    msg = (
        f"mesh.num_model={num_model} puts a model group on hosts {bad[0]} (ranks per host "
        f"{counts}): the embedding-table all-to-all would cross hosts. Set num_model to a "
        "divisor of the smallest per-host rank count, or order the ranks host by host."
    )
    if not config.allow_dcn_model_axis:
        raise ValueError(msg)
    logger.warning("%s Proceeding because mesh.allow_dcn_model_axis=true.", msg)


def build_mesh(
    config: MeshConfig,
    *,
    device: str | torch.device | None = None,
    backend: str | None = None,
) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the process group
    (joined here as ``initialize_multihost`` does if no group exists yet).

    ``num_model`` divides the world size; ``num_data = -1`` infers the
    rest. ``device`` is ``cuda`` unless the caller asks for the CPU; the
    backend is the device's (``default_backend``) unless ``backend`` names
    one. A world of one process still builds the mesh and runs its
    collectives."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    initialize_multihost(backend=backend)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, the mesh asks "
                         f"for {backend!r}")
    world, rank = dist.get_world_size(), dist.get_rank()
    num_model = config.num_model
    if world % num_model:
        raise ValueError(f"num_model={num_model} does not divide the world size {world}")
    num_data = config.num_data if config.num_data > 0 else world // num_model
    if num_data * num_model != world:
        raise ValueError(f"mesh {num_data}x{num_model} != world size {world} "
                         "(set mesh.num_data=-1 to infer)")
    dev = _rank_device(dev, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    hosts: list = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    check_model_groups_on_hosts(config, hosts, num_model)
    from torch.distributed.device_mesh import init_device_mesh

    # The DeviceMesh's device type names where its collectives run: gloo's
    # in host memory, whatever device the tensors live on.
    mesh_device = "cuda" if backend == "nccl" else "cpu"
    dm = init_device_mesh(mesh_device, (num_data, num_model),
                          mesh_dim_names=(config.data_axis, config.model_axis))
    d_idx, m_idx = rank // num_model, rank % num_model
    mesh = Mesh(
        config=config, num_data=num_data, num_model=num_model, rank=rank, device=dev,
        backend=backend, device_mesh=dm,
        data=Axis(config.data_axis, dm.get_group(config.data_axis), num_data, d_idx),
        model=Axis(config.model_axis, dm.get_group(config.model_axis), num_model, m_idx),
        combined=Axis("combined", dist.group.WORLD, world, rank),
    )
    logger.info(
        "mesh: %d rank(s) over %d host(s) as (%s=%d, %s=%d), backend %s on %s%s; this is "
        "rank %d (d=%d, m=%d)",
        world, len(set(hosts)), config.data_axis, num_data, config.model_axis, num_model,
        backend, dev, "" if world > 1 else " (a world of one: the mesh code runs, its "
        "collectives over one rank)", rank, d_idx, m_idx,
    )
    return mesh

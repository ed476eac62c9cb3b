"""Analytic scaling-efficiency model for the sharded sparse train step.

Counterpart of ``twotower_tpu/parallel/scaling_model.py``: every
communication term of the sparse mesh step (``parallel/sparse_spmd.py``) is
a static shape, so the per-step traffic is exact, and the efficiency is
predictable from published link rates plus a measured one-card step time.
It is a prediction, not a measurement: a machine with several cards is
where it can be checked (``parallel/scaling.py``).

Communication inventory per step (shapes from ``parallel/sparse_spmd.py``;
D = num_data, M = num_model, W = D*M, B = global batch, b = B/D, k = b/M,
E = embedding dim, F = tower output dim, cap = a2a bucket capacity, P =
dense tower params):

1. table a2a over the COMBINED axis: 4 calls (2 lookups + 2 row-update
   routes) x W*cap*(4 + 4E) bytes out of every rank (int32 ids and float32
   rows, ``parallel/a2a.py``), plus, for mixed/uniform, the shared-negative
   lookup and the negative share of the item update route. The exchange
   spans ALL W ranks: destinations on the host ride NVLink, the rest the
   NIC; placing the model axis on one host keeps term 2, not this one, on
   NVLink.
2. TOWER-OUTPUT reassembly all_gather + its reduce_scatter transpose along
   ``model``: item columns 2 directions x b*F*4 x (M-1)/M, negatives 2 x
   negs*F*4 x (M-1)/M; user outputs are consumed per peer; uniform
   sampling gathers negatives only. On one host by construction
   (``parallel/mesh.py``'s host-locality refusal).
3. item-column all_gather along ``data`` for the in_batch/mixed loss + its
   reduce-scatter transpose: (2*B*F*4 + 8B) x (D-1)/D a rank; zero for
   uniform sampling and for ``retrieval.shard_local_negatives``.
4. dense-grad all-reduce over the COMBINED axis: ring, 2*(W-1)/W * g*P
   bytes a rank, g = 4 or 2 (``mesh.dense_grad_dtype=bfloat16``).
5. metric all-reduces: scalars, ignored.

Link classes (the JAX module's two, with H100 figures as the defaults;
every call can override them): ``ici`` is the link inside one NVLink
domain, ``dcn`` the network between hosts.

- NVLink 4: 900 GB/s of total bandwidth a GPU, both directions together,
  so 450 GB/s one way (NVIDIA H100 Tensor Core GPU datasheet, "NVLink:
  900GB/s" for the SXM form factor; NVIDIA Hopper architecture in-depth
  whitepaper: 18 fourth-generation links, 900 GB/s total).
- The host's network: one ConnectX-7 NIC, 400 Gb/s = 50 GB/s (NVIDIA
  ConnectX-7 400G adapter datasheet; the DGX H100 pairs each GPU with one
  such port).

``single_slice=True`` puts every rank inside one NVLink domain (one host,
up to ``chips_per_host`` cards): no traffic crosses the network. False
models ranks on several hosts: the a2a's cross-host share is rank to rank
over the NIC, and the data-axis collectives cross the network once a host.
The default is True exactly when the world fits on one host.

Two readings: ``serial`` (no overlap of compute and communication, a lower
bound) and ``overlapped`` (perfect overlap, an upper bound).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

# H100 SXM link rates (module docstring for the sources), bytes a second.
NVLINK_BYTES_PER_S = 4.5e11  # NVLink 4, one direction, one GPU
NIC_BYTES_PER_S = 5.0e10  # ConnectX-7, 400 Gb/s, one host
CARDS_PER_HOST = 8  # an HGX/DGX H100 board


def a2a_capacity(k: int, num_shards: int, factor: float) -> int:
    """The bucket capacity of the port's sparse step
    (``parallel.sparse_spmd._capacity``, the one source)."""
    from twotower_tpu_torch.parallel.sparse_spmd import _capacity

    return _capacity(k, num_shards, factor)


def a2a_bytes_per_device(
    batch: int, num_data: int, num_model: int, emb_dim: int, factor: float
) -> int:
    """Exact a2a payload bytes a rank a step: 4 exchange calls (user/item
    lookup + user/item row update), each moving ``W x cap`` int32 ids and
    float32 rows out of every rank."""
    world = num_data * num_model
    k = batch // num_data // num_model
    cap = a2a_capacity(k, world, factor)
    return 4 * world * cap * (4 + 4 * emb_dim)


@dataclass
class StepTraffic:
    """Per-step communication bytes, split by link class."""

    a2a_per_device: int
    model_ag_per_device: int
    data_ag_per_device: int
    dense_psum_per_device: int
    ici_per_device: int
    dcn_per_host: int

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def sparse_step_traffic(
    *,
    batch: int,
    num_data: int,
    num_model: int,
    emb_dim: int,
    out_dim: int,
    capacity_factor: float,
    dense_params: int,
    chips_per_host: int = CARDS_PER_HOST,
    text_tokens: int = 0,
    sampling: str = "in_batch",
    shard_local: bool = False,
    num_negatives: int = 0,
    dense_grad_bytes: int = 4,
    single_slice: bool | None = None,
) -> StepTraffic:
    """Exact per-step traffic of the sparse mesh step (terms 1-4 above).

    ``text_tokens > 0`` adds the text-table exchange (one more lookup and
    update pair over ``b*T`` token ids); ``sampling`` / ``shard_local``
    select term 3's treatment; mixed/uniform add the shared-negative
    exchange. ``single_slice``: None for ``world <= chips_per_host``."""
    world = num_data * num_model
    if single_slice is None:
        single_slice = world <= chips_per_host
    hosts = max(1, world // chips_per_host)
    b = batch // num_data
    f = out_dim
    sample_negs = sampling in ("mixed", "uniform")
    negs_padded = -(-num_negatives // num_model) * num_model if sample_negs else 0
    row_bytes = 4 + 4 * emb_dim  # int32 id + float32 row

    # term 1: the table a2a over the combined axis
    a2a = a2a_bytes_per_device(batch, num_data, num_model, emb_dim, capacity_factor)
    if text_tokens:
        k_tok = b * text_tokens // num_model
        a2a += 2 * world * a2a_capacity(k_tok, world, capacity_factor) * row_bytes
    if sample_negs:
        k = b // num_model
        k_neg = negs_padded // num_model
        a2a += world * a2a_capacity(k_neg, world, capacity_factor) * row_bytes
        # the item update route carries the negatives' gradients too
        k_up = (b + negs_padded) // num_model
        a2a += world * row_bytes * (
            a2a_capacity(k_up, world, capacity_factor)
            - a2a_capacity(k, world, capacity_factor)
        )

    # term 2: model-axis all_gather + reduce_scatter of the tower outputs
    gathered_rows = negs_padded + (b if sampling != "uniform" else 0)
    model_ag = 2 * gathered_rows * f * 4 * (num_model - 1) // max(num_model, 1)

    # term 3: the data-axis item-column all_gather and its transpose
    has_item_ag = sampling in ("in_batch", "mixed") and not shard_local
    data_ag = (
        (2 * batch * f * 4 + 8 * batch) * (num_data - 1) // max(num_data, 1)
        if has_item_ag
        else 0
    )

    # term 4: the dense-gradient ring all-reduce over the combined axis
    dense_psum = 2 * (world - 1) * dense_grad_bytes * dense_params // max(world, 1)

    if single_slice:
        ici = int(a2a + model_ag + data_ag + dense_psum)
        dcn_per_host = 0
    else:
        c = min(chips_per_host, world)
        a2a_dcn_frac = (world - c) / world
        data_payload = (2 * batch * f * 4 + 8 * batch) if has_item_ag else 0
        psum_payload = 2 * dense_grad_bytes * dense_params
        dcn_per_host = int(
            c * a2a * a2a_dcn_frac
            + (data_payload + psum_payload) * (hosts - 1) / max(hosts, 1)
        )
        ici = int(a2a * (1 - a2a_dcn_frac) + model_ag + data_ag + dense_psum)
    return StepTraffic(
        a2a_per_device=int(a2a),
        model_ag_per_device=int(model_ag),
        data_ag_per_device=int(data_ag),
        dense_psum_per_device=int(dense_psum),
        ici_per_device=ici,
        dcn_per_host=dcn_per_host,
    )


@dataclass
class EfficiencyReport:
    traffic: StepTraffic
    compute_ms: float
    ici_ms: float
    dcn_ms: float
    efficiency_serial: float
    efficiency_overlapped: float
    meta: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dict(self.__dict__)
        d["traffic"] = self.traffic.as_dict()
        return d


def predicted_efficiency(
    traffic: StepTraffic,
    *,
    compute_ms: float,
    ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
    dcn_bytes_per_s: float = NIC_BYTES_PER_S,
    **meta,
) -> EfficiencyReport:
    """Efficiency against the one-card step at the same batch a card.
    ``compute_ms``: that step's measured time. ``serial`` adds the
    communication to it; ``overlapped`` takes the larger."""
    ici_ms = traffic.ici_per_device / ici_bytes_per_s * 1e3
    dcn_ms = traffic.dcn_per_host / dcn_bytes_per_s * 1e3
    serial = compute_ms / (compute_ms + ici_ms + dcn_ms)
    overlapped = compute_ms / max(compute_ms, ici_ms, dcn_ms)
    return EfficiencyReport(
        traffic=traffic,
        compute_ms=compute_ms,
        ici_ms=round(ici_ms, 4),
        dcn_ms=round(dcn_ms, 4),
        efficiency_serial=round(serial, 4),
        efficiency_overlapped=round(overlapped, 4),
        meta=meta,
    )


def preset_report(config, *, compute_ms: float, dense_params: int,
                  chips_per_host: int = CARDS_PER_HOST, single_slice: bool | None = None,
                  ici_bytes_per_s: float = NVLINK_BYTES_PER_S,
                  dcn_bytes_per_s: float = NIC_BYTES_PER_S) -> EfficiencyReport:
    """The prediction for a ``Config``'s mesh, model and loss settings."""
    m, r = config.mesh, config.retrieval
    world = m.num_data * m.num_model
    if single_slice is None:
        single_slice = world <= chips_per_host
    traffic = sparse_step_traffic(
        batch=config.training.batch_size,
        num_data=m.num_data,
        num_model=m.num_model,
        emb_dim=config.model.embedding_dim,
        out_dim=config.model.output_dim,
        capacity_factor=m.a2a_capacity_factor,
        dense_params=dense_params,
        chips_per_host=chips_per_host,
        text_tokens=(config.model.text_tokens if config.model.text_buckets else 0),
        sampling=r.candidate_sampling,
        shard_local=r.shard_local_negatives,
        num_negatives=r.num_negatives,
        dense_grad_bytes=(2 if m.dense_grad_dtype == "bfloat16" else 4),
        single_slice=single_slice,
    )
    return predicted_efficiency(
        traffic,
        compute_ms=compute_ms,
        ici_bytes_per_s=ici_bytes_per_s,
        dcn_bytes_per_s=dcn_bytes_per_s,
        mesh=f"{m.num_data}x{m.num_model}",
        batch=config.training.batch_size,
        chips_per_host=chips_per_host,
        sampling=r.candidate_sampling,
        shard_local=r.shard_local_negatives,
        single_slice=single_slice,
    )


def dense_tower_params(config) -> int:
    """Parameter count of the dense (non-table) part: both tower MLPs."""
    e = config.model.embedding_dim
    total = 0
    for dims in (config.model.user_tower_dims, config.model.item_tower_dims):
        prev = e
        for d in dims:
            total += prev * d + d
            prev = d
    return total


def main(argv: list[str] | None = None) -> None:
    import argparse

    from twotower_tpu_torch.config import load_config, parse_cli_overrides

    ap = argparse.ArgumentParser(
        description="Predict the sparse mesh step's scaling efficiency for a preset"
    )
    ap.add_argument("--config", default=None)
    ap.add_argument("--override", nargs="*", default=[], metavar="KEY=VALUE",
                    help="config overrides (mesh.num_data, mesh.num_model, ...)")
    ap.add_argument(
        "--compute-ms", type=float, required=True,
        help="the measured one-card step ms at the preset's batch a card",
    )
    ap.add_argument("--chips-per-host", type=int, default=CARDS_PER_HOST)
    ap.add_argument("--ici-bytes-per-s", type=float, default=NVLINK_BYTES_PER_S)
    ap.add_argument("--dcn-bytes-per-s", type=float, default=NIC_BYTES_PER_S)
    args = ap.parse_args(argv)
    cfg = load_config(args.config, parse_cli_overrides(args.override))
    rep = preset_report(
        cfg,
        compute_ms=args.compute_ms,
        dense_params=dense_tower_params(cfg),
        chips_per_host=args.chips_per_host,
        ici_bytes_per_s=args.ici_bytes_per_s,
        dcn_bytes_per_s=args.dcn_bytes_per_s,
    )
    rep.meta["config"] = args.config
    print(json.dumps(rep.as_dict(), indent=2))


if __name__ == "__main__":
    main()

"""Execution-rung auto-selection for ``train-model`` (the PyTorch port's
copy of ``twotower_tpu/training/rungs.py``).

The trainer has three execution rungs:

- ``device_loop``: encoded train columns resident in device memory; the
  permutation is drawn on the device and every step is one replay of the
  step captured as a CUDA graph (``training/device_loop.py``). Full
  permutation per epoch, no per-step host work.
- ``host``: train columns in host RAM, full-permutation shuffle, batches
  dispatched through the host loop (``training/loop.py``).
- ``stream``: out-of-core windowed-shuffle streaming from the prepared
  parquet; bounded host memory, window size = metric-quality dial.

``choose_execution_rung`` picks the best rung the measured budgets allow;
explicit ``--device-loop`` / ``--stream-batches`` / ``--exec`` flags force.
The decision and its byte constants are the JAX package's, unchanged
(including the 16 GB assumed when the device budget is unknown); it is PURE
(all budgets are inputs) so it is unit-testable. ``device_free_bytes`` reads
``torch.cuda.mem_get_info`` and the caching allocator's free reserve on a
CUDA device, and ``host_available_bytes`` ``/proc/meminfo``.
"""

from __future__ import annotations

from dataclasses import dataclass

from twotower_tpu_torch.logging_utils import get_logger

logger = get_logger(__name__)

# Resident bytes per train row on device: user_idx + item_idx int32 +
# weight f32 (DeviceDataset.columns).
_DEVICE_ROW_BYTES = 12
# Transient headroom per row for the epoch program: the permutation
# (int32) plus the gathered shuffled copies the scan consumes.
_DEVICE_ROW_TRANSIENT = 24
# Fixed device workspace besides state + columns: the eval encode of the
# corpus is counted separately; this covers loss/score buffers, collective
# scratch, and fragmentation slop.
_DEVICE_WORKSPACE = 2 << 30
# Host bytes per train row for the in-RAM path: u/i/ts columns plus the
# split copies (measured ~2x the raw 16B columns at 50M rows).
_HOST_ROW_BYTES = 32
# Streaming window cost: two int32 buffers plus eviction copies.
_STREAM_ROW_BYTES = 16


@dataclass
class RungDecision:
    rung: str  # "device_loop" | "host" | "stream"
    shuffle_buffer: int | None  # stream rung only
    reason: str


def train_state_bytes(config, num_users: int, num_items: int) -> int:
    """f32 params + packed Adam moments for the tables (3x rows x E), plus
    the dense towers (x3 for param + 2 moments). Mirrors
    ``TrainState.for_config``'s sparse layout; the dense-optimizer layout
    is the same total."""
    e = config.model.embedding_dim
    rows = num_users + num_items + 2  # + dead rows (padded tables)
    if config.model.text_buckets:
        rows += config.model.text_buckets + 1
    table = rows * e * 4 * 3
    dense = 0
    for dims in (config.model.user_tower_dims, config.model.item_tower_dims):
        prev = e
        for d in dims:
            dense += (prev * d + d) * 4 * 3
            prev = d
    return table + dense


def eval_corpus_bytes(config, num_items: int) -> int:
    itemsize = 2 if config.retrieval.eval_corpus_dtype == "bfloat16" else 4
    return num_items * config.model.embedding_dim * itemsize


def choose_execution_rung(
    *,
    n_train: int,
    num_users: int,
    num_items: int,
    config,
    device_free_bytes: int | None,
    host_available_bytes: int | None,
    multi_process: bool = False,
    has_eval: bool = True,
) -> RungDecision:
    """Pick the highest rung whose memory requirement fits the budget.

    ``device_free_bytes``: free HBM on one chip (None = unknown -> assume
    16 GB, the v5e figure). ``host_available_bytes``: MemAvailable (None =
    unknown -> be conservative, stream). ``multi_process``: the device
    loop is single-controller only — multi-controller runs cap at host.
    """
    if device_free_bytes is None:
        device_free_bytes = 16 << 30
    state = train_state_bytes(config, num_users, num_items)
    corpus = eval_corpus_bytes(config, num_items) if has_eval else 0
    device_need = (
        state
        + corpus
        + n_train * (_DEVICE_ROW_BYTES + _DEVICE_ROW_TRANSIENT)
        + _DEVICE_WORKSPACE
    )
    if not multi_process and device_need <= device_free_bytes:
        return RungDecision(
            "device_loop",
            None,
            f"train columns + state fit HBM (need ~{device_need >> 20} MiB "
            f"of {device_free_bytes >> 20} MiB: state {state >> 20}, "
            f"corpus {corpus >> 20}, columns "
            f"{(n_train * _DEVICE_ROW_BYTES) >> 20} + transient)",
        )
    host_need = n_train * _HOST_ROW_BYTES
    if host_available_bytes is not None and host_need <= host_available_bytes // 2:
        return RungDecision(
            "host",
            None,
            f"columns exceed HBM (need ~{device_need >> 20} MiB of "
            f"{device_free_bytes >> 20} MiB) but fit host RAM "
            f"(~{host_need >> 20} MiB of {host_available_bytes >> 20} MiB "
            "available): full-permutation shuffle via the host loop",
        )
    # Stream: size the window as large as the host allows (quality dial —
    # PARITY.md measured r@10 0.0046/0.0065/0.0072 for 1M/8M/full at 50M
    # rows), capped at n_train (== a full permutation) and floored at the
    # batch size by the pipeline itself.
    budget = (host_available_bytes or (4 << 30)) // 4
    window = max(1 << 20, min(n_train, budget // _STREAM_ROW_BYTES))
    return RungDecision(
        "stream",
        int(window),
        f"columns fit neither HBM (~{device_need >> 20} MiB) nor host RAM "
        f"budget; streaming with a {window:,}-row shuffle window",
    )


def device_free_bytes(device=None) -> int | None:
    """Free memory of the CUDA ``device`` (default: the current one): the
    free bytes ``cudaMemGetInfo`` reports plus what PyTorch's caching
    allocator holds reserved but unused. None for the CPU, which has no
    device budget."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(dev)
    return int(free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev))


def host_available_bytes() -> int | None:
    """MemAvailable from /proc/meminfo (None off-Linux)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover
        return None
    return None

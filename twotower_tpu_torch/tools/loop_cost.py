"""What the training loop costs on top of the bare train step, on one CUDA
card: the host loop's input and dispatch, and the device loop's replays.

    python3 twotower_tpu_torch/tools/loop_cost.py

The default model (embedding 128, towers [512,256,128], bf16 compute,
dropout 0.1, log q, lazy-Adam tables, host dedup) at batch 4096 over the
tables of ``chip_smoke.py`` phase 7 (198,072 users x 99,978 items) and
1,764,928 uniformly drawn training rows, in one process, each mode for
``STEPS`` steps after ``WARM`` warm-up steps, the wall time ending in one
``torch.cuda.synchronize``:

- ``device``: batches (with the host dedup keys) already on the card: the
  dispatch of the step and its device work only;
- ``host``: the same batches as numpy arrays, moved inside the step
  (pageable copies on the dispatching thread);
- ``prefetch``: ``BatchPipeline`` -> host dedup -> ``DevicePrefetcher``
  with ``torch_put`` (pinned copies on the prefetch thread), as the Trainer
  feeds the step, but without the Trainer;
- ``trainer``: ``Trainer.fit`` for one epoch of the same pipeline, no
  validation or checkpoint: examples / epoch wall time (its
  ``steady_examples_per_sec``, the whole epoch, first steps included);
- ``graph``: the device loop (``training/device_loop.py``) over the same
  rows as columns on the card: the step (in-device dedup) captured as a
  CUDA graph in a first epoch, then ``STEPS`` replays of the second;
- ``device_trainer``: ``DeviceTrainer.fit`` for one epoch (its warm-up
  steps and the capture included), no validation or checkpoint.

``device`` against ``host`` and ``prefetch`` prices the input's way onto the
card, ``graph`` against ``device`` the host's dispatch of some 300 launches a
step, and ``trainer`` / ``device_trainer`` the loop around the step.

It prints one ``loop_cost: {...}`` line a mode (ms a step, examples/s) and
the card's name and power limit. Any failure exits non-zero.
"""

from __future__ import annotations

import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(HERE))

NUM_USERS, NUM_ITEMS, ROWS, BATCH = 198_072, 99_978, 1_764_928, 4096
WARM, STEPS = 20, 200


def _card_line() -> str:
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.card_line()


class _Columns:
    def __init__(self, rng):
        self.user_idx = rng.integers(0, NUM_USERS, ROWS).astype(np.int32)
        self.item_idx = rng.integers(0, NUM_ITEMS, ROWS).astype(np.int32)

    def __len__(self) -> int:
        return ROWS


def _timed(step, state, batches, gen) -> float:
    """ms a step over STEPS steps after WARM, one synchronise at the end."""
    it = iter(batches)
    for b in itertools.islice(it, WARM):
        state, _ = step(state, b, gen)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for b in itertools.islice(it, STEPS):
        state, m = step(state, b, gen)
    float(m["loss"])
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / STEPS


def main() -> int:
    if not torch.cuda.is_available():
        print("loop_cost: no CUDA device visible", file=sys.stderr)
        return 1
    from twotower_tpu_torch.config import Config
    from twotower_tpu_torch.data import BatchPipeline, DevicePrefetcher, torch_put
    from twotower_tpu_torch.models.two_tower import dead_row
    from twotower_tpu_torch.training import Trainer
    from twotower_tpu_torch.training.device_loop import (
        DeviceDataset,
        DeviceTrainer,
        make_epoch_fn,
    )
    from twotower_tpu_torch.training.host_dedup import augment_epoch

    torch.backends.cuda.matmul.allow_tf32 = False
    print(_card_line(), flush=True)
    cfg = Config().with_overrides({
        "training.batch_size": BATCH, "training.epochs": 1, "training.log_every_steps": 100,
    })
    cols = _Columns(np.random.default_rng(0))
    log_q = np.log(np.full(NUM_ITEMS, 1.0 / NUM_ITEMS))
    trainer = Trainer(cfg, log_q=log_q, num_items=NUM_ITEMS)
    state = trainer.init_state(NUM_USERS, NUM_ITEMS)
    deads = dict(user_dead=dead_row(state.params["user_embedding"]),
                 item_dead=dead_row(state.params["item_embedding"]))
    pipe = BatchPipeline(cols, BATCH, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = WARM + STEPS
    host = list(itertools.islice(augment_epoch(pipe.epoch(0), **deads), n))
    put = torch_put("cuda")
    on_card = [put(b) for b in host]
    modes = {
        "device": lambda: _timed(trainer.train_step, state, on_card, gen),
        "host": lambda: _timed(trainer.train_step, state, host, gen),
        "prefetch": lambda: _timed(
            trainer.train_step, state,
            DevicePrefetcher(augment_epoch(pipe.epoch(1), **deads), torch_put("cuda")), gen),
    }
    for name, run in modes.items():
        ms = run()
        print("loop_cost: " + json.dumps(
            {"mode": name, "ms_per_step": ms, "examples_per_sec": BATCH / ms * 1e3}), flush=True)
    result = trainer.fit(state, pipe, start_epoch=0)
    _report("trainer", result)
    state = result.state

    ds = DeviceDataset(cols.user_idx, cols.item_idx, BATCH, device="cuda")
    lq = torch.as_tensor(log_q, dtype=torch.float32, device="cuda")
    prog = make_epoch_fn(cfg, trainer.optimizer, ds.num_steps, num_items=NUM_ITEMS)
    state, _ = prog(state, ds.columns, 0, lq)  # warm-up steps and the capture
    prog.begin_epoch(state, ds.columns, 1, lq)
    for _ in range(WARM):
        prog.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(STEPS):
        prog.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / STEPS
    for _ in range(ds.num_steps - WARM - STEPS):
        prog.step()
    state, _ = prog.end_epoch()
    print("loop_cost: " + json.dumps(
        {"mode": "graph", "ms_per_step": ms, "examples_per_sec": BATCH / ms * 1e3}), flush=True)
    _report("device_trainer", DeviceTrainer(cfg, log_q=log_q, num_items=NUM_ITEMS).fit(state, ds))
    return 0


def _report(mode: str, result) -> None:
    eps = result.steady_examples_per_sec
    print("loop_cost: " + json.dumps(
        {"mode": mode, "ms_per_step": BATCH / eps * 1e3, "examples_per_sec": eps,
         "steps": int(result.state.step)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

"""Where the forward kernel's time goes, on one CUDA card: builds copies of
``ops/csrc/fused_loss.cu`` with parts of the kernel switched off and times
each at B=4096, D=128.

    python3 twotower_tpu_torch/tools/fwd_ablate.py

A variant is the kernel source with a few exact edits (an edit that no longer
matches the source fails the run). Only ``full`` computes the right outputs;
the others are for timing:

- ``full``: the kernel as it is;
- ``no_epilogue``: no masking, exps or row statistics on the accumulators;
- ``one_kstep``: one k-step of MMAs a tile instead of sixteen;
- ``no_split``: the producer copies every tile but splits only the first two;
- ``no_copies``: the producer copies only the first kAhead tiles and splits
  every tile from them;
- ``mma_only``: no epilogue, no copies or splits after the first tiles (the
  MMAs, the barriers, the owned rows' prologue and the outputs);
- ``skeleton``: ``mma_only`` with one k-step;
- ``no_tiles``: no tile at all (prologue, outputs, the merge pass).

Each variant is compiled by its own ``nvcc`` (all at once) into
``build/fwd_ablate/`` and timed in this process: the device time of the main
kernel and of the merge pass by ``torch.profiler`` (the mean of 20 calls,
after 3), and ``ms_batched`` as ``chip_smoke.py`` takes it. It prints one
line ``ablate: {...}`` a variant, in the order full, variants, full, and the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(HERE))

from twotower_tpu_torch.ops import build, kernels  # noqa: E402

OUT = HERE / "build" / "fwd_ablate"

_MMAS = (
    "      wgmma_n64(acc, a_hi[ks], d_b, acc_on);\n"
    "      wgmma_n32_ss(acc_lh, smem_desc(a_lo + ks * 2 * kLbo, kLbo, kSbo), d_b, acc_on);\n"
)
_ONE_KSTEP = (_MMAS, "      if (ks == 0) {\n" + _MMAS + "      }\n")
_NO_EPILOGUE = (
    "__EPILOGUE__",
    "    pos[0] += acc[0] + acc[16] + acc_lh[0] + vcol[0] + vid[1];\n"
    "    pos[1] += acc[5] + acc[21] + acc_lh[7] + vcol[3] + vid[7];\n  }\n\n",
)
_NO_SPLIT = (
    "      for (int j = 0; j < kChunks; ++j) {\n        const float4 x",
    "      for (int j = 0; j < kChunks; ++j) if (step < 2) {\n        const float4 x",
)
_NO_COPIES = (
    "      if (step < nsteps) {\n        const int t = t0_of(step) + row",
    "      if (step < kAhead) {\n        const int t = t0_of(step) + row",
)
_NO_TILES = (
    "  const int nsteps = max(tile_end - tile_begin, 0) * nchunks;",
    "  const int nsteps = 0 * max(tile_end - tile_begin, 0) * nchunks;",
)
VARIANTS = {
    "full": [],
    "no_epilogue": [_NO_EPILOGUE],
    "one_kstep": [_ONE_KSTEP],
    "no_split": [_NO_SPLIT],
    "no_copies": [_NO_COPIES],
    "mma_only": [_NO_EPILOGUE, _NO_SPLIT, _NO_COPIES],
    "skeleton": [_ONE_KSTEP, _NO_EPILOGUE, _NO_SPLIT, _NO_COPIES],
    "no_tiles": [_NO_TILES],
}


def variant_source(edits) -> str:
    src = (build.CSRC / "fused_loss.cu").read_text()
    # The epilogue: from the per-tile column numbering to the end of the tile loop.
    start = src.index("    const int base = t0_of(step) + 2 * tq;")
    epilogue = src[start:src.index("  // The 4 lanes of a row merge")]
    for old, new in edits:
        old = epilogue if old == "__EPILOGUE__" else old
        if src.count(old) != 1:
            raise RuntimeError(f"edit does not match fused_loss.cu once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants() -> dict[str, Path]:
    procs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fused_loss.cu").write_text(variant_source(edits))
        procs[name] = subprocess.Popen(
            [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(d / "fused_loss.so"), str(d / "fused_loss.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        if any(int(n) for n in re.findall(r"(\d+) bytes spill stores", log)):
            print(f"ablate: variant {name} spills registers", flush=True)
    return {name: OUT / name / "fused_loss.so" for name in VARIANTS}


def use(lib_path: Path) -> None:
    lib = ctypes.CDLL(str(lib_path))
    lib.tt_fused_loss_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_void_p] * 6
    lib.tt_fused_loss_fwd.restype = ctypes.c_int
    lib.tt_fused_loss_fwd_scratch.argtypes = [ctypes.c_int] * 3
    lib.tt_fused_loss_fwd_scratch.restype = ctypes.c_longlong
    kernels._fwd_lib = lambda: lib
    kernels._scratch_floats.cache_clear()


def device_us(fn, calls: int = 20) -> dict[str, float]:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "fused_loss_fwd" in e.key:
            name = "merge" if "merge" in e.key else "kernel"
            out[name] = e.self_device_time_total / e.count
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fwd_ablate: no CUDA device visible", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line(), flush=True)
    libs = build_variants()
    u, v, ids, cols, _ = smoke.loss_inputs(smoke.MAIN_B, smoke.MAIN_D, smoke.MAIN_B, seed=7)
    args = (u, v, ids, cols, 0, 1 / smoke.TEMP)
    ref = kernels.fwd_plain(*args)
    for name in ["full", *[n for n in VARIANTS if n != "full"], "full"]:
        use(libs[name])
        got = kernels.fused_fwd(*args)
        torch.cuda.synchronize()
        right = all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(got, ref))
        if name == "full" and not right:
            raise RuntimeError("the unchanged kernel disagrees with fwd_plain")

        def call():
            return kernels.fused_fwd(*args)

        print("ablate: " + json.dumps({
            "variant": name, "right": right, "device_us": device_us(call),
            "ms_batched": smoke.time_ms_batched(call),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

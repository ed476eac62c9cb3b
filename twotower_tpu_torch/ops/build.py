"""Build and load the port's CUDA kernels, and count their launches.

Each ``.cu`` source under ``ops/csrc/`` is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``. The build runs at first use, into ``build/torch_kernels/``
beside the package (listed in ``.gitignore``); the library's file name
carries a hash of its source, of every header under ``csrc/`` (the loss
sources share ``sm90_tf32.cuh``; the search and attention sources
``sm90_tma.cuh`` too)
and of the flags, so an edited source or header is rebuilt and an
unchanged one is reused; nvcc's report (``-Xptxas -v``: registers and
spills a kernel) is kept beside it as ``.log``. Nothing here runs at import
time: the CPU tests import every module on a machine with no ``nvcc``.

The wrappers that launch the kernels (``ops/kernels.py``'s loss,
``ops/prefilter.py``'s search, ``ops/attention.py``'s sequence-tower
attention) share the rest: ``on_cpu`` sends CPU tensors
to the plain versions, ``raise_on`` turns a launch's error into an
exception, and each wrapper marked ``counted`` counts its launches in
``<wrapper>.launches``: one set of counts, reset together by
``reset_launch_counts``. A launch made while a CUDA graph is captured does
not run then: it is recorded in the ``record_launches()`` record open at
the time, whose ``replayed()`` adds it to the counts on each replay of the
graph.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("fused_loss.cu", "fused_loss_bwd.cu", "search_prefilter.cu",
           "search_prefilter_f32.cu", "stream_attention.cu")

build_logs: dict[str, str] = {}  # source -> nvcc's output (-Xptxas -v: registers, spills)


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(
            f"{name} not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels need the CUDA toolkit"
        )
    return found


def _digest(source: str) -> str:
    """Hash of what a library is built from: its source, every header under
    ``csrc/`` (by name and bytes) and the flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def compile_library(cmd: list[str], out: Path) -> str:
    """Run ``cmd + ["-o", tmp]`` and rename ``tmp`` to ``out``: a concurrent
    build never loads a half-written library. Returns the compiler's
    output; raises ``RuntimeError`` with it if the compiler fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=out.suffix, dir=out.parent)
    os.close(fd)
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed for {out.name}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def _build(source: str) -> Path:
    src = CSRC / source
    digest = _digest(source)
    out = BUILD_DIR / f"{src.stem}-{digest[:16]}.so"
    log = out.with_suffix(".log")
    if out.exists():
        build_logs.setdefault(source, log.read_text() if log.exists() else "(cached build)")
        return out
    build_logs[source] = compile_library([cuda_tool("nvcc"), *NVCC_FLAGS, str(src)], out)
    log.write_text(build_logs[source])
    return out


def build_all() -> dict[str, Path]:
    """Compile every source, one ``nvcc`` per source, all started together."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        paths = list(pool.map(_build, SOURCES))
    return dict(zip(SOURCES, paths))


def load(source: str) -> ctypes.CDLL:
    """Load one source's library, building it first if needed."""
    return ctypes.CDLL(str(_build(source)))


# ---------------------------------------------------------------------------
# What the kernel wrappers share
# ---------------------------------------------------------------------------


def on_cpu(what: str, *tensors: torch.Tensor) -> bool:
    """Whether a wrapper's inputs are CPU tensors (its plain version runs);
    False for tensors on one CUDA device; raises for any other mix."""
    devs = {t.device for t in tensors}
    if {d.type for d in devs} == {"cpu"}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{what} inputs must share one CPU or CUDA device, got "
                         f"{sorted(map(str, devs))}")
    return False


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a C pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


# Every counted wrapper, in the order their modules define them.
_COUNTED: list = []


def counted(wrapper):
    """Marks ``wrapper`` as one that counts its kernel's launches in
    ``wrapper.launches`` (through ``count``)."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


def reset_launch_counts() -> None:
    for w in _COUNTED:
        w.launches = 0


class LaunchRecord:
    """The kernel launches of one captured CUDA graph, by wrapper."""

    def __init__(self):
        self.counts: Counter = Counter()

    def replayed(self, times: int = 1) -> None:
        """Count the recorded launches once for each of ``times`` replays."""
        for w, n in self.counts.items():
            w.launches += n * times


# The record of the capture in progress, if any (one capture at a time: the
# CUDA graph API captures one graph a process under the global mode).
_capture: list[LaunchRecord] = []


@contextlib.contextmanager
def record_launches():
    """Around a CUDA graph's capture: yields the ``LaunchRecord`` that the
    launches captured inside go to."""
    if _capture:
        raise RuntimeError("record_launches() is already open")
    rec = LaunchRecord()
    _capture.append(rec)
    try:
        yield rec
    finally:
        _capture.clear()


def count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: counted now, or, while the current
    stream is being captured into a CUDA graph (the launch then runs only on
    replay), recorded for the replays to count."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1
    elif _capture:
        _capture[0].counts[wrapper] += 1
    else:
        raise RuntimeError(
            f"{wrapper.__name__} captured in a CUDA graph outside record_launches(): "
            "its replays would go uncounted"
        )

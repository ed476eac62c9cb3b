"""Build and load the port's CUDA kernels.

Each ``.cu`` source under ``ops/csrc/`` is compiled with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, loaded
with ``ctypes``. The build runs at first use, into ``build/torch_kernels/``
beside the package (listed in ``.gitignore``); the library's file name
carries a hash of its source, of every header under ``csrc/`` (the sources
share ``sm90_tf32.cuh``) and of the flags, so an edited source or header
is rebuilt and an unchanged one is reused; nvcc's report (``-Xptxas -v``:
registers and spills a kernel) is kept beside it as ``.log``. Nothing here
runs at import time: the CPU tests import every module on a machine with
no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("fused_loss.cu", "fused_loss_bwd.cu", "search_prefilter.cu",
           "search_prefilter_f32.cu")

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

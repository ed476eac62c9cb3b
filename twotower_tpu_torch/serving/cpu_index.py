"""ctypes binding for the native C++ flat MIPS index (the port's counterpart
of ``twotower_tpu/serving/cpu_index.py``).

Builds the port's own ``native/flat_index.cpp`` with ``g++`` into a shared
library at first use, into ``build/native/`` beside the CUDA kernels'
``build/torch_kernels/`` (``ops/build.py``'s build to a temporary name and
rename). The library's name carries a hash of the source, the flags and
the host (``-march=native`` code is for the CPU that built it), so an
edited source is rebuilt and a checkout copied to another machine builds
its own. Without a toolchain the index falls back to NumPy, as the JAX
package's does: the same exact results, slower; the backend taken is
logged and read from ``backend``.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
from pathlib import Path

import numpy as np

from twotower_tpu_torch.logging_utils import get_logger
from twotower_tpu_torch.ops import build

logger = get_logger(__name__)

SRC = Path(__file__).resolve().parents[1] / "native" / "flat_index.cpp"
BUILD_DIR = build.BUILD_DIR.parent / "native"
GXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fopenmp", "-shared", "-fPIC")
_LIB_CACHE: dict[str, ctypes.CDLL] = {}


def library_path() -> Path:
    """Where the library for this source, these flags and this host lives."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(f"{platform.machine()} {platform.node()}".encode())
    return BUILD_DIR / f"flat_index-{h.hexdigest()[:16]}.so"


def _build_library() -> ctypes.CDLL | None:
    """Compile (once) and load the shared library; None if it cannot be built."""
    lib_path = library_path()
    if str(lib_path) in _LIB_CACHE:
        return _LIB_CACHE[str(lib_path)]
    if not lib_path.exists():
        try:
            build.compile_library(["g++", *GXX_FLAGS, str(SRC)], lib_path)
            logger.info("built native flat index -> %s", lib_path)
        except (OSError, RuntimeError) as e:
            logger.warning("native index build failed (%s); using the NumPy backend", e)
            return None
    lib = ctypes.CDLL(str(lib_path))
    lib.flat_topk.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.flat_topk.restype = None
    lib.flat_index_num_threads.argtypes = []
    lib.flat_index_num_threads.restype = ctypes.c_int32
    _LIB_CACHE[str(lib_path)] = lib
    return lib


class CpuFlatIndex:
    """Exact CPU MIPS index over a fixed corpus ``[n, d]`` float32."""

    def __init__(self, corpus: np.ndarray, *, force_numpy: bool = False):
        self.corpus = np.ascontiguousarray(corpus, np.float32)
        if self.corpus.ndim != 2:
            raise ValueError("corpus must be [n, d]")
        self._lib = None if force_numpy else _build_library()
        if self._lib is not None:
            logger.info(
                "CpuFlatIndex: native backend, %d threads, %d items",
                self.num_threads, len(self.corpus),
            )
        else:
            logger.info("CpuFlatIndex: NumPy backend, %d items", len(self.corpus))

    @property
    def backend(self) -> str:
        return "native" if self._lib is not None else "numpy"

    @property
    def num_threads(self) -> int:
        """OpenMP threads of the native search (1 for the NumPy backend)."""
        return int(self._lib.flat_index_num_threads()) if self._lib is not None else 1

    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k: returns (scores [b, k] descending, indices [b, k])."""
        queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        n, d = self.corpus.shape
        b, dq = queries.shape
        if dq != d:
            raise ValueError(f"query dim {dq} != corpus dim {d}")
        if not 1 <= k <= n:
            raise ValueError(f"k={k} must be in [1, {n}]")
        if self._lib is not None:
            scores = np.empty((b, k), np.float32)
            idx = np.empty((b, k), np.int32)
            self._lib.flat_topk(
                self.corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n, d,
                queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                b, k,
                scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
            return scores, idx
        all_scores = queries @ self.corpus.T
        part = np.argpartition(-all_scores, k - 1, axis=1)[:, :k]
        part_scores = np.take_along_axis(all_scores, part, axis=1)
        order = np.argsort(-part_scores, axis=1, kind="stable")
        idx = np.take_along_axis(part, order, axis=1).astype(np.int32)
        scores = np.take_along_axis(part_scores, order, axis=1).astype(np.float32)
        return scores, idx

    @classmethod
    def from_npz(cls, path: str | Path, **kw) -> "CpuFlatIndex":
        with np.load(path) as data:
            return cls(data["corpus"], **kw)

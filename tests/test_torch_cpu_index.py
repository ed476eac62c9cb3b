"""The port's native CPU index (``serving/cpu_index.py`` over its own
``native/flat_index.cpp``) against the JAX package's ``CpuFlatIndex``.

The port's native backend and the JAX package's build the same source with
the same flags on this host, so they agree bit for bit; so do the two NumPy
backends. Native against NumPy: scores rtol 1e-5 (the native dot products
are vectorised under -ffast-math and sum in another order) and ids equal
outside scores tied within that tolerance.
"""

import logging

import numpy as np
import pytest

from twotower_tpu.serving.cpu_index import CpuFlatIndex as JaxCpuFlatIndex
from twotower_tpu_torch.ops import build
from twotower_tpu_torch.serving import CpuFlatIndex
from twotower_tpu_torch.serving import cpu_index

ROOT = cpu_index.SRC.parents[2]


def _data(n, d, b, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


def assert_same_topk(scores, ids, ref_scores, ref_ids, rtol=1e-5):
    """Scores within ``rtol``; ids equal outside tied ranks: where they
    differ, the reference's score there equals a neighbour's within it."""
    atol = rtol * np.abs(ref_scores).max()
    np.testing.assert_allclose(scores, ref_scores, rtol=rtol, atol=atol)
    padded = np.pad(ref_scores, ((0, 0), (1, 1)), constant_values=np.nan)
    tied = (np.isclose(ref_scores, padded[:, :-2], rtol=rtol, atol=atol)
            | np.isclose(ref_scores, padded[:, 2:], rtol=rtol, atol=atol))
    assert (tied | (ids == ref_ids)).all()


@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("n,d,b,k", [(2000, 64, 16, 20), (777, 30, 5, 777), (64, 8, 1, 1)])
def test_backend_matches_jax_bit_for_bit(backend, n, d, b, k):
    corpus, q = _data(n, d, b)
    force = backend == "numpy"
    ours = CpuFlatIndex(corpus, force_numpy=force)
    ref = JaxCpuFlatIndex(corpus, force_numpy=force)
    assert ours.backend == ref.backend == backend
    s, i = ours.search(q, k)
    rs, ri = ref.search(q, k)
    assert s.dtype == np.float32 and i.dtype == np.int32 and s.shape == i.shape == (b, k)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(i, ri)
    assert (np.diff(s, axis=1) <= 0).all()


def test_native_matches_numpy():
    corpus, q = _data(5000, 128, 32, seed=3)
    s, i = CpuFlatIndex(corpus).search(q, 100)
    rs, ri = CpuFlatIndex(corpus, force_numpy=True).search(q, 100)
    assert_same_topk(s, i, rs, ri)
    assert (i == ri).mean() > 0.99
    exact = q.astype(np.float64) @ corpus.T.astype(np.float64)
    np.testing.assert_allclose(s, np.take_along_axis(exact, i, axis=1), rtol=1e-5, atol=1e-5)


def test_builds_under_build_native_from_the_ports_source(caplog):
    with caplog.at_level(logging.INFO, logger="twotower_tpu_torch.serving.cpu_index"):
        index = CpuFlatIndex(np.eye(4, dtype=np.float32))
    path = cpu_index.library_path()
    assert path.parent == ROOT / "build" / "native" == build.BUILD_DIR.parent / "native"
    assert path.exists() and index.backend == "native" and index.num_threads >= 1
    assert cpu_index.SRC == ROOT / "twotower_tpu_torch" / "native" / "flat_index.cpp"
    assert any("native backend" in m for m in caplog.messages)


def test_numpy_fallback_without_a_toolchain(tmp_path, monkeypatch, caplog):
    def no_gxx(cmd, out):
        raise OSError("g++: not found")

    monkeypatch.setattr(cpu_index, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "compile_library", no_gxx)
    corpus, q = _data(300, 16, 4)
    with caplog.at_level(logging.INFO, logger="twotower_tpu_torch.serving.cpu_index"):
        index = CpuFlatIndex(corpus)
    assert index.backend == "numpy" and index.num_threads == 1
    assert any("NumPy backend" in m for m in caplog.messages)
    np.testing.assert_array_equal(index.search(q, 7)[1],
                                  CpuFlatIndex(corpus, force_numpy=True).search(q, 7)[1])


def test_rejects_bad_shapes_and_k():
    corpus, q = _data(10, 8, 2)
    index = CpuFlatIndex(corpus)
    for bad_k in (0, 11):
        with pytest.raises(ValueError, match="k="):
            index.search(q, bad_k)
    with pytest.raises(ValueError, match="query dim"):
        index.search(q[:, :4], 3)
    with pytest.raises(ValueError, match=r"\[n, d\]"):
        CpuFlatIndex(corpus[0])


def test_from_npz_and_single_query(tmp_path):
    corpus, q = _data(50, 8, 1)
    np.savez(tmp_path / "corpus.npz", corpus=corpus)
    index = CpuFlatIndex.from_npz(tmp_path / "corpus.npz")
    s, i = index.search(q[0], 5)  # a 1-D query is one row
    rs, ri = JaxCpuFlatIndex.from_npz(tmp_path / "corpus.npz").search(q[0], 5)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(i, ri)

"""The kernel build's cache key: a library is rebuilt when its source, any
header under ``csrc/`` or the flags change, and reused otherwise. No
``nvcc`` is needed: only the digest is computed."""

import pytest

from twotower_tpu_torch.ops import build


@pytest.fixture()
def csrc(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "h.cuh"\nint f() { return g(); }\n')
    (tmp_path / "h.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_digest_is_stable(csrc):
    assert build._digest("a.cu") == build._digest("a.cu")


@pytest.mark.parametrize("edit", ["source", "header", "new header", "flags"])
def test_digest_changes_with_what_the_library_is_built_from(csrc, monkeypatch, edit):
    before = build._digest("a.cu")
    if edit == "source":
        (csrc / "a.cu").write_text('#include "h.cuh"\nint f() { return g() + 1; }\n')
    elif edit == "header":
        (csrc / "h.cuh").write_text("inline int g() { return 2; }\n")
    elif edit == "new header":
        (csrc / "k.cuh").write_text("// another shared header\n")
    else:
        monkeypatch.setattr(build, "NVCC_FLAGS", (*build.NVCC_FLAGS, "-lineinfo"))
    assert build._digest("a.cu") != before


def test_every_source_builds_from_the_shared_header():
    for source in build.SOURCES:
        assert '#include "sm90_tf32.cuh"' in (build.CSRC / source).read_text()

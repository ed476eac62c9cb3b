"""``float32_products()`` under both of PyTorch's TF32 switches.

The switch is process-wide, and once a process sets the new API
(``torch.backends.cuda.matmul.fp32_precision``) reading the legacy flag
(``allow_tf32``) raises. So each case runs in a fresh interpreter: the
caller sets TF32 on through one API (or through neither), then the exact
and the approximate searches must return the ids and scores they return
without the setting, and the caller's setting must read back unchanged.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CHILD = r"""
import sys
import torch
from twotower_tpu_torch.ops import topk

case = sys.argv[1]
gen = torch.Generator().manual_seed(0)
q, c = torch.randn(16, 24, generator=gen), torch.randn(700, 24, generator=gen)

def search():
    return (topk.topk_mips_twopass(q, c, 10, chunk_size=256),
            topk.topk_mips_approx(q, c, 10),
            topk.topk_mips(q, c, 10, chunk_size=128))

ref = search()
m = torch.backends.cuda.matmul
if case == "new":
    m.fp32_precision = "tf32"
elif case == "legacy":
    m.allow_tf32 = True
got = search()
for (rv, ri), (gv, gi) in zip(ref, got):
    assert torch.equal(rv, gv) and torch.equal(ri, gi), case
if case == "new":
    assert m.fp32_precision == "tf32", m.fp32_precision
elif case == "legacy":
    assert m.allow_tf32 is True
else:
    assert not m.allow_tf32 and not topk.matmul_tf32()
print("ok", case)
"""


@pytest.mark.parametrize("case", ["new", "legacy", "neither"])
def test_search_under_each_tf32_api(case):
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, case],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith(f"ok {case}")

"""Nothing under ``perfbench/`` imports JAX or the JAX package (top-level
module names compared whole: ``twotower_tpu_torch`` begins with
``twotower_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "twotower_tpu"}
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports (also inside
    functions)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names |= {a.value.split(".")[0] for a in node.args
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN
    if "tests" not in path.relative_to(BENCH).parts:  # reads neither bench.py nor benchmarks/
        text = path.read_text()
        assert "/bench.py" not in text and " bench.py" not in text and "benchmarks/" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported(path)
    assert "twotower_tpu_torch" not in names
    assert names <= {"__future__", "math", "torch", "perfbench", "numpy"}, names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("perfbench"):
            assert node.module.startswith("perfbench.reference"), node.module


def test_whole_names_are_compared():
    from perfbench.harness.runner import loaded_forbidden

    assert "twotower_tpu" not in loaded_forbidden() or "twotower_tpu" in sys.modules
    code = ("import sys; sys.path.insert(0, '.'); import twotower_tpu_torch.config; "
            "from perfbench.harness.runner import loaded_forbidden; "
            "print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"

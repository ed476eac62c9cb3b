"""Each cell's control must come out not correct: the reference in the
precision below the configuration's (``harness/program.py``), put in the
program's place, read against the reference with the committed limits, at a
tiny size on the CPU; the program's own readings of the same run pass."""

import pytest

from perfbench.control import readings
from perfbench.harness.manifest import load_cell
from perfbench.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny_control"))


@pytest.mark.parametrize("workload", ["c3_train", "c3_validate", "c3_eval_exact", "c4_serve"])
def test_the_control_fails_a_limit(root, workload):
    cell = load_cell(root, workload)
    limits = cell.traffic["check"]
    got = readings(cell, 2**31 + 99, 0.3, "cpu")
    assert all(got["program"][k] <= limits[k] for k in limits), got["program"]
    assert any(got["control"][k] > limits[k] for k in limits), got["control"]

"""``BENCHMARK.json`` against the contract's forms, and every cell, mix and
metric found by its name; a configuration, a traffic mix and a metric
added in a copy are found without editing any file."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench.harness.manifest import driver_of, load_cell, load_manifest, metric_reader

REPO = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
MANIFEST = load_manifest(REPO)
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", *KEYS}
    assert MANIFEST["command"] == ["python3", "perfbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in MANIFEST["paths"])
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_names_and_units(section):
    entries = MANIFEST[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) <= KEYS[section], e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = load_cell(REPO, workload)
    assert cell.chips == 1
    assert callable(driver_of(cell).setup)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(metric_reader(cell, m["name"]).read)
    for key in cell.config["reduced"]:
        assert NAME.match(key)


def test_an_added_config_traffic_and_metric_are_found_by_name(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    bench = tmp_path / "perfbench"
    conf = json.loads((bench / "configs" / "lifecycle_50m_1chip.json").read_text())
    conf["num_items"] = 12345
    (bench / "configs" / "dummy_cfg.json").write_text(json.dumps(conf))
    traffic = json.loads((bench / "traffic" / "train_lifecycle_epochs.json").read_text())
    traffic["rows_per_epoch"] = 777
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "dummy.metric_pct.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dummy_cfg", "source": "https://example.org/d",
                                "file": "perfbench/configs/dummy_cfg.json", "reduced": [],
                                "why": "a dummy"})
    manifest["workloads"].append({"name": "dummy_cell", "config": "dummy_cfg",
                                  "traffic": "dummy_mix", "chips": 1, "why": "a dummy"})
    manifest["end_to_end"][0]["workloads"].append("dummy_cell")
    manifest["per_layer"].append({"name": "dummy.metric_pct", "unit": "%", "better": "higher",
                                  "source": "host_clock", "layer": "device",
                                  "moves": manifest["end_to_end"][0]["name"],
                                  "workloads": ["dummy_cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = load_cell(tmp_path, "dummy_cell")
    assert cell.config["num_items"] == 12345
    assert cell.traffic["rows_per_epoch"] == 777
    assert driver_of(cell).__file__.startswith(str(tmp_path))
    assert "dummy.metric_pct" in [m["name"] for m in cell.per_layer]
    assert metric_reader(cell, "dummy.metric_pct").read(None) == 42.0
    after = {p: p.read_bytes() for p in before}
    assert after == before  # no file that was there changed


@pytest.mark.parametrize("path", sorted((REPO / "perfbench" / "traffic").glob("*.json")),
                         ids=lambda p: p.stem)
def test_traffic_restates_nothing_the_configuration_states(path):
    """The precision a reference scores at, the control's and the search a
    trace times follow from the configuration and the mix's ``overrides``
    (``harness/program.py``), so that no two settings can disagree."""
    traffic = json.loads(path.read_text())
    assert not {"reference_precision", "control_precision", "search"} & set(traffic)


def test_no_driver_imports_another():
    import ast

    for path in sorted((REPO / "perfbench" / "drivers").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module:
                assert not node.module.startswith("perfbench.drivers"), (path.name, node.module)


def test_controls_are_the_precision_below():
    from perfbench.harness.program import control_of

    assert [control_of(p) for p in ("float32", "bfloat16", "int8")] == ["tf32", "fp8", "int4"]

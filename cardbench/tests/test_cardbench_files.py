"""Every cell of BENCHMARK.json resolves to its files by name, and a new
deployment, mix or metric file is picked up without an edit."""

import dataclasses
import json
import re
import shutil

import pytest
from conftest import ROOT

import harness

BENCH = harness.load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves_to_its_files(workload):
    cell = harness.resolve(BENCH, workload, ROOT)
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert cell.mix["sensor"]["rows"] == cell.deployment["config"]["detection"]["rows"]
    assert cell.mix["sensor"]["columns"] == cell.deployment["config"]["detection"]["columns"]
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"], ROOT))
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "scans_per_s", "scan_ms_p95"}


@pytest.mark.parametrize("file", sorted(p.name for p in (ROOT / "cardbench/deployments").glob("*.json")))
def test_deployment_file_is_the_preset_as_run(file):
    from dynamic_direct_lidar_odometry_tpu_torch import config as port_config

    with open(ROOT / "cardbench/deployments" / file) as f:
        dep = json.load(f)
    cfg = harness.build_config(dep)
    preset = getattr(port_config, dep["preset"])()
    if dep["preset"] == "kantplatz_config":
        preset = dataclasses.replace(preset, capacity=port_config.capacity_for_scan(512, 512))
    assert cfg == preset
    hash(cfg)  # a graph cache keys on it


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_new_files_are_found_by_name(tmp_path):
    """A copy of the tree with a new deployment, mix and metric added as
    files and entries only."""
    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    dep = json.loads((ROOT / "cardbench/deployments/doals-os1-64.json").read_text())
    dep["config"]["capacity"]["max_tracks"] = 32
    (tmp_path / "cardbench/deployments/doals-small.json").write_text(json.dumps(dep))
    mix = json.loads((ROOT / "cardbench/traffic/loop-walk.json").read_text())
    mix["path"]["radius"] = 6.0
    (tmp_path / "cardbench/traffic/loop-small.json").write_text(json.dumps(mix))
    (tmp_path / "cardbench/limits/doals.small.json").write_text(json.dumps({"step_mm": 9.0}))
    (tmp_path / "cardbench/metrics/steps_traced.py").write_text(
        "def read(view):\n    return float(len(view.steps))\n")
    bench["configs"].append(dict(name="doals-small", source="x", file="cardbench/deployments/doals-small.json",
                                 reduced=["capacity"], why="x"))
    bench["workloads"].append(dict(name="doals.small", config="doals-small", traffic="loop-small",
                                   chips=1, why="x"))
    bench["per_layer"].append(dict(name="steps_traced", unit="count", better="higher",
                                   source="program_span", layer="entry", moves="scans_per_s"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve(harness.load_benchmark(tmp_path), "doals.small", tmp_path)
    assert harness.build_config(cell.deployment).capacity.max_tracks == 32
    assert cell.mix["path"]["radius"] == 6.0 and cell.limits == {"step_mm": 9.0}
    assert "steps_traced" in [m["name"] for m in cell.per_layer]
    view = type("V", (), {"steps": [(0, 1), (1, 2)]})()
    assert harness.metric_reader("steps_traced", tmp_path)(view) == 2.0

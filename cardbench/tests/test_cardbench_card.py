"""On the card: one short run of each cell prints a result line that keeps
the benchmark's contract (skips without a card)."""

import json
import subprocess
import sys

import pytest
from conftest import ROOT

import harness

CELLS = [w["name"] for w in harness.load_benchmark(ROOT)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_keeps_the_contract(card, workload, trace):
    out = subprocess.run([sys.executable, "cardbench/run.py", "--workload", workload,
                          "--seed", str(2**33 + 5), "--seconds", "2", "--trace", str(trace)],
                         capture_output=True, text=True, timeout=900, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    cell = harness.resolve(harness.load_benchmark(ROOT), workload, ROOT)
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want} <= set(res["metrics"])
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert len(res["breakdown"]["device_ops"]) <= 10

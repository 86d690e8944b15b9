"""The benchmark's own tests (run with ``python -m pytest cardbench/tests``;
the repository's suite under ``tests/`` does not collect them). They run
on the CPU at tiny sizes; those marked ``gpu`` need the card and skip
elsewhere."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(workload: str = "doals.stream1", rows: int = 16, columns: int = 256,
              lap: int = 336, streams: int = 1):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds: the
    sensor and the capacities shrunk, everything else as the files say."""
    import harness

    cell = harness.resolve(harness.load_benchmark(ROOT), workload, ROOT)
    cell.deployment = copy.deepcopy(cell.deployment)
    c = cell.deployment["config"]
    det = c["detection"]
    for k, full, now in (("window_row", det["rows"], rows), ("window_col", det["columns"], columns)):
        for end in ("_min", "_max"):
            if det[k + end] is not None:  # the window kept at its share of the scan
                det[k + end] = det[k + end] * now // full
    det["rows"], det["columns"] = rows, columns
    c["capacity"].update(max_points=2048, max_submap_points=8192, max_keyframes=8,
                         max_keyframe_points=2048, max_objects=16, max_tracks=16,
                         segment_candidates=32, nn_chunk=512)
    cell.mix = copy.deepcopy(cell.mix)
    cell.mix["sensor"].update(rows=rows, columns=columns)
    cell.mix["path"]["scans_per_lap"] = lap
    cell.mix["streams"] = streams
    cell.mix["stream_spacing"] = lap // streams if streams > 1 else 0
    return cell


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

"""The ``seg_roots_per_scan`` reader on a made-up traced stretch's counts,
and on the counts of a program that has no ``seg_roots`` key."""

import pytest

import harness
import timeline
from conftest import ROOT


def _view(counts, streams=8, steps=6):
    # a fleet of 8 over 6 steps: 48 stream-scans
    return timeline.TraceView(stream_scans=streams * steps, lo=0.0, hi=1.0, device=[], host=[],
                              counts=counts, entry_host_ms=[])


@pytest.mark.parametrize("counts,value", [
    ({"seg_roots": 48 * 97, "ccl_sweeps": 240}, 97.0),
    ({"seg_roots": 48 * 200 + 24, "segment_objects": 48}, 200.5),
    ({"nn1_sparse": 160, "ccl_sweeps": 240}, None),  # a program without the count
    ({}, None),
])
def test_seg_roots_reader(counts, value):
    got = harness.metric_reader("seg_roots_per_scan", ROOT)(_view(counts))
    assert got == (None if value is None else pytest.approx(value))

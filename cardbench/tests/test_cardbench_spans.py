"""The span and trial readers (``graph_device_ms``, the stage and entry
spans, ``lm_trials_per_scan``) on a made-up traced stretch's counts."""

import pytest

import harness
import timeline
from conftest import ROOT

STAGES = {"preprocess_ms": "preprocess", "covariance_ms": "covariances", "s2s_ms": "s2s",
          "submap_ms": "submap", "s2m_ms": "s2m", "detection_ms": "detection",
          "tracker_ms": "tracker", "keyframes_ms": "keyframes"}


def _view(streams=8, steps=6):
    # a fleet of 8 over 6 steps: 48 stream-scans, 6 graph replays
    counts = {"span.graph.ns": 6 * 20_000_000, "span.graph.n": 6, "lm_trials": 240,
              "host.entry.prepare.ns": 6 * 300_000, "host.entry.copy_in.ns": 6 * 900_000,
              "host.entry.clone.ns": 6 * 600_000, "host.entry.launch.ns": 6 * 1_200_000,
              "host.entry.launch.n": steps}
    for k, span in enumerate(STAGES.values()):
        counts[f"span.{span}.ns"] = (k + 1) * 48 * 100_000
        counts[f"span.{span}.n"] = 48
    return timeline.TraceView(stream_scans=streams * steps, lo=0.0, hi=1.0, device=[], host=[],
                              counts=counts, entry_host_ms=[])


@pytest.mark.parametrize("name,value", [
    ("graph_device_ms", 20.0), ("lm_trials_per_scan", 5.0),
    ("entry_prepare_ms", 0.3), ("entry_copy_ms", 1.5), ("entry_launch_ms", 1.2),
] + [(m, 0.1 * (k + 1)) for k, m in enumerate(STAGES)])
def test_span_readers_on_made_up_counts(name, value):
    assert harness.metric_reader(name, ROOT)(_view()) == pytest.approx(value)


@pytest.mark.parametrize("name", ["graph_device_ms", "lm_trials_per_scan", "entry_prepare_ms",
                                  "entry_copy_ms", "entry_launch_ms"] + list(STAGES))
def test_span_readers_on_a_program_without_spans(name):
    """The counts of a program that has no spans (only its older keys):
    each reader returns None and does not raise."""
    v = _view()
    v.counts = {"nn1_sparse": 160, "ccl_sweeps": 240}
    assert harness.metric_reader(name, ROOT)(v) is None


def test_entry_copy_needs_both_parts():
    v = _view()
    del v.counts["host.entry.clone.ns"]
    assert harness.metric_reader("entry_copy_ms", ROOT)(v) is None

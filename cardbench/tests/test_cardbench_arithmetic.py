"""The percentile, rate and idle arithmetic, and the per-layer readers, on
made-up timelines."""

import math

import pytest

import harness
import stats
import timeline
from conftest import ROOT


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs[::-1], 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 1000], 95) == 1000
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate():
    assert stats.rate(300, 2.5) == 120.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_union_idle_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (6, 7), (9, 12)]
    assert stats.merge(iv) == [(0, 3), (5, 7), (9, 12)]
    assert stats.busy(iv) == 8
    assert stats.idle_share(iv, 0, 10) == pytest.approx(1 - 6 / 10)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (7, 9)]
    assert stats.gaps(iv, -1, 13) == [(-1, 0), (3, 5), (7, 9), (12, 13)]


def _view():
    # two steps (graph launches at 1 and 11) over a stretch of 20 us;
    # device work 0-4, 3-6 (overlap) and 12-15; the host's CUDA calls
    return timeline.TraceView(
        stream_scans=4, lo=0.0, hi=20.0,
        device=[(0.0, 4.0, "k_a"), (3.0, 6.0, "k_b"), (12.0, 15.0, "k_a")],
        host=[(0.0, 1.0, "cudaMemcpyAsync"), (1.0, 2.0, "cudaGraphLaunch"),
              (6.0, 10.0, "cudaStreamSynchronize"), (10.0, 11.0, "cudaMemcpyAsync"),
              (11.0, 12.0, "cudaGraphLaunch"), (15.0, 16.0, "cudaStreamSynchronize")],
        counts={"nn1_sparse": 12, "ccl_sweeps": 20}, entry_host_ms=[1.0, 3.0])


@pytest.mark.parametrize("name,value", [
    ("entry_host_ms", 2.0), ("graph_copies_per_scan", 0.5),
    ("gicp_linearizations_per_scan", 3.0), ("ccl_sweeps_per_scan", 5.0),
    ("kernels_per_scan", 0.75), ("device_busy_ms_per_scan", 9e-3 / 4),
    ("device_idle_pct", 100 * (1 - 9 / 20)),
])
def test_readers_on_a_made_up_stretch(name, value):
    assert harness.metric_reader(name, ROOT)(_view()) == pytest.approx(value)


def test_readers_find_nothing_and_say_so():
    v = _view()
    v.device, v.host, v.counts, v.entry_host_ms = [], [], {}, []
    v.lo = v.hi = 0.0
    for m in harness.load_benchmark(ROOT)["per_layer"]:
        assert harness.metric_reader(m["name"], ROOT)(v) is None


def test_breakdown_names_ops_and_idle_by_host():
    v = _view()
    b = timeline.breakdown(v)
    assert b["device_ops"][0] == ["k_a", pytest.approx(7e-6)]
    idle = dict((n, s) for n, s in b["idle_gaps"])
    # gaps: 6-12 (its midpoint in a synchronizing call) and 15-20 (its
    # midpoint outside every CUDA call)
    assert idle == {"cudaStreamSynchronize": pytest.approx(6e-6),
                    "host outside CUDA calls": pytest.approx(5e-6)}
    assert math.isclose(sum(idle.values()), 11e-6)
    assert timeline.summary(v) == dict(busy_s=pytest.approx(9e-6), window_s=pytest.approx(20e-6))


def test_steps_run_from_one_graph_launch_to_the_next():
    v = _view()
    assert v.steps == [(1.0, 11.0), (11.0, 20.0)]
    assert v.device_ops_per_step() == [1, 1]  # k_b; the second k_a
    assert v.device_ops() == 3

"""The readers of the spans nested in ``detection`` (``det_project_ms``,
``ccl_ms``, ``det_objects_ms``) on a made-up traced stretch's counts, on
the counts of a program without them, and on a traced step of the
program on the CPU."""

import pytest

import harness
import timeline
from conftest import ROOT

PARTS = {"det_project_ms": "detection.project", "ccl_ms": "detection.ccl",
         "det_objects_ms": "detection.objects"}


def _view(counts, stream_scans=48):
    return timeline.TraceView(stream_scans=stream_scans, lo=0.0, hi=1.0, device=[], host=[],
                              counts=counts, entry_host_ms=[])


@pytest.mark.parametrize("name,span", sorted(PARTS.items()))
def test_reader_gives_device_ms_a_stream_scan(name, span):
    counts = {"span.detection.ns": 48 * 2_000_000, "span.detection.n": 48,
              f"span.{span}.ns": 48 * 500_000, f"span.{span}.n": 48}
    assert harness.metric_reader(name, ROOT)(_view(counts)) == pytest.approx(0.5)


@pytest.mark.parametrize("name", sorted(PARTS))
def test_reader_on_a_program_without_the_span(name):
    """A program with the ``detection`` span alone (the parent's): None,
    no error."""
    counts = {"span.detection.ns": 48 * 2_000_000, "span.detection.n": 48, "ccl_sweeps": 240}
    assert harness.metric_reader(name, ROOT)(_view(counts)) is None
    assert harness.metric_reader(name, ROOT)(_view(counts, stream_scans=0)) is None


def test_parts_sum_to_at_most_detection_in_a_traced_step():
    """The program's own counts from two traced steps on the CPU of the
    kantplatz deployment on ``k4a-walk``'s camera, both cut to 32 x 32:
    every part read, their sum at most ``detection_ms``."""
    import json

    import torch

    from dynamic_direct_lidar_odometry_tpu_torch import config, pipeline
    from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling
    from traffic import generator

    dep = json.loads((ROOT / "cardbench/deployments/kantplatz-k4a-512.json").read_text())
    det = dep["config"]["detection"]
    for k in ("window_row_min", "window_row_max", "window_col_min", "window_col_max"):
        det[k] = det[k] * 32 // 512
    det["rows"] = det["columns"] = 32
    dep["config"]["capacity"] = dict(dep["config"]["capacity"], **{
        f.name: getattr(config.capacity_for_scan(32, 32), f.name)
        for f in config.CapacityConfig.__dataclass_fields__.values()})
    cfg = harness.build_config(dep)
    mix = generator.load_mix("k4a-walk", ROOT / "cardbench" / "traffic")
    mix["sensor"].update(rows=32, columns=32)
    lap = generator.render_lap(mix, 2**33 + 5, "cpu", scans=[0, 1, 2])
    pts = torch.nan_to_num(lap.points)
    st = pipeline.init_state(cfg, pts[0], lap.mask[0], 0.0, T0=torch.as_tensor(lap.scene.poses[0]),
                             device="cpu")
    with profiling.device_counts("cpu") as c:
        for i in (1, 2):
            st, _ = pipeline.step(cfg, st, pts[i], lap.mask[i], float(mix["dt"]) * i)
    view = _view(dict(c), stream_scans=2)
    parts = [harness.metric_reader(m, ROOT)(view) for m in PARTS]
    total = harness.metric_reader("detection_ms", ROOT)(view)
    assert all(p is not None and p > 0 for p in parts)
    assert sum(parts) <= total

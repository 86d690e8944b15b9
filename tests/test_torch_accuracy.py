"""The port's accuracy tool (tools/torch_accuracy.py) against the JAX
package's (tools/accuracy_tpu.py), on the CPU: the same pairwise ATE, the
same bars, a host leg equal to ``runner.replay`` called directly, and card
legs that refuse to run without a card."""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest

from torch_parity import port_cfg
from torch_replay_parity import _seq, lean_cfg

from dynamic_direct_lidar_odometry_tpu_torch import runner
from dynamic_direct_lidar_odometry_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


acc = _load("torch_accuracy")
jacc = _load("accuracy_tpu")


def _run(rng, stamps, dropped=0, scale=0.01):
    return dict(poses=rng.normal(size=(len(stamps), 3)).astype(np.float32) * scale,
                stamps=np.asarray(stamps, np.float64), dropped=dropped)


def _pair(case, seed=0):
    rng = np.random.default_rng(seed)
    stamps = np.arange(1, 64) * 0.1
    if case == "equal_stamps":
        return _run(rng, stamps), _run(rng, stamps)
    if case == "gaps_and_shifted_start":
        keep = np.ones(63, bool)
        keep[[3, 17, 18, 40]] = False
        return _run(rng, stamps[5:]), _run(rng, stamps[keep])
    if case == "no_common_stamp":
        return _run(rng, stamps[:10]), _run(rng, stamps[20:])
    return _run(rng, stamps, dropped=1), _run(rng, stamps)


@pytest.mark.parametrize("case", ["equal_stamps", "gaps_and_shifted_start", "no_common_stamp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_ate_is_the_jax_tools(case, seed):
    a, b = _pair(case, seed)
    got, want = acc.pairwise_ate(a, b), jacc.pairwise_ate(a, b)
    if case == "no_common_stamp":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert got == want and got > 0


@pytest.mark.parametrize("swap", [False, True])
def test_pairwise_ate_refuses_dropped_scans_as_the_jax_tools(swap):
    a, b = _pair("dropped")
    if swap:
        a, b = b, a
    for fn in (acc.pairwise_ate, jacc.pairwise_ate, acc.max_divergence):
        with pytest.raises(RuntimeError, match="dropped 1 scans"):
            fn(a, b)


@pytest.mark.parametrize("case", ["equal_stamps", "gaps_and_shifted_start"])
def test_max_divergence_is_the_largest_stamp_aligned_distance(case):
    a, b = _pair(case)
    common, ia, ib = np.intersect1d(a["stamps"], b["stamps"], return_indices=True)
    want = np.linalg.norm(a["poses"][ia] - b["poses"][ib], axis=1).max()
    got = acc.max_divergence(a, b)
    assert got == float(want)
    assert got >= acc.pairwise_ate(a, b)


def _jax_tool_bars():
    """The ``"bars"`` entry of the JAX tool's report, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "accuracy_tpu.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "bars":
                    return ast.literal_eval(v)
    raise AssertionError("no bars in tools/accuracy_tpu.py")


def test_bars_are_the_jax_tools():
    assert acc.BARS == _jax_tool_bars() == {
        "default_vs_exact_lt_m": 0.01, "device_vs_exact_hulls_lt_m": 0.01, "vs_gt_lt_m": 0.05}
    gates = {(a, b): (m, bar) for a, b, m, bar in acc.GATES}
    assert gates[("gpu_default", "gpu_exact")] == ("rmse", 0.01)
    assert gates[("gpu_default", "gpu_exact_hulls")] == ("rmse", 0.01)
    assert gates[("gpu_default", "jax_cpu_window")] == ("max", 0.01)
    assert gates[("gpu_exact", "jax_cpu_exact")] == ("max", 0.01)


def _fake_runs(offsets, ate=0.0066):
    """Four card legs and two goldens on one trajectory, leg ``name``
    moved by ``offsets[name]`` metres along x on every scan."""
    base = np.stack([np.arange(1, 64) * 0.2, np.zeros(63), np.zeros(63)], -1).astype(np.float32)
    stamps = np.arange(1, 64) * 0.1
    flags = np.zeros(63, bool)
    flags[[9, 30]] = True

    def run(name):
        return dict(poses=base + np.float32([offsets.get(name, 0.0), 0, 0]), stamps=stamps, dropped=0,
                    ate=ate, num_keyframes=3, map_points=1000, keyframe_added=flags.copy(), seconds=1.0,
                    total_ms_per_scan=dict(mean=70.0, min=60.0, max=90.0, n=62), launches={},
                    linearizations=400, covariance_calls=67, launch_check=True)

    legs = {n: run(n) for n in acc.CARD_LEGS}
    goldens = {n: run(n) for n in ("jax_cpu_exact", "jax_cpu_window")}
    return legs, goldens


@pytest.mark.parametrize("offsets, ok", [
    ({}, True),
    ({"gpu_default": 0.009}, True),
    ({"gpu_default": 0.0101}, False),  # vs gpu_exact, gpu_exact_hulls and jax_cpu_window
    ({"gpu_exact": 0.0101, "gpu_laneclass": 0.0101, "gpu_default": 0.0101, "gpu_exact_hulls": 0.0101},
     False),  # only the JAX runs are off now
    ({"gpu_laneclass": 0.0101}, False),
])
def test_report_holds_the_bars(offsets, ok):
    legs, goldens = _fake_runs(offsets)
    rep = acc.report(legs, goldens, "card", 64)
    assert rep["pass"] is ok
    assert not rep["gates_not_run"]
    assert json.loads(json.dumps(rep)) == rep  # one JSON line in chip_smoke.py
    assert all(g["ok"] for g in rep["gates"]) is ok
    assert rep["bars"]["vs_gt_lt_m"] == 0.05
    for a, b, _, _ in acc.GATES:
        pair = rep["pairs"][f"{a}_vs_{b}"]
        assert pair["max_divergence_m"] >= pair["rmse_m"]


def test_report_fails_on_ground_truth_and_launches():
    legs, goldens = _fake_runs({}, ate=0.051)
    assert not acc.report(legs, goldens, "card", 64)["pass"]
    legs, goldens = _fake_runs({})
    legs["gpu_exact"]["launch_check"] = False
    assert not acc.report(legs, goldens, "card", 64)["pass"]
    legs, goldens = _fake_runs({})
    legs["gpu_default"]["keyframe_added"][20] = True
    rep = acc.report(legs, goldens, "card", 64)
    assert rep["pass"]  # keyframes are reported, not gated
    assert rep["legs"]["gpu_default"]["first_keyframe_flag_difference_vs_jax_cpu_window"] == 21
    assert rep["legs"]["gpu_exact"]["first_keyframe_flag_difference_vs_jax_cpu_exact"] is None


@pytest.mark.parametrize("path, launches, ok", [
    ("none", {}, True),
    ("none", {"nn1_sparse": 0}, True),
    ("none", {"nn1_sparse": 1}, False),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30}, True),
    ("sparse", {"nn1_sparse": 29, "nn1_key_fill": 29}, False),
    ("sparse", {"nn1_sparse": 30, "knn_classes": 1}, False),
    ("sparse", {"nn1_sparse": 30, "nn1_dense": 1}, False),
    ("laneclass", {"nn1_sparse": 30, "knn_classes": 7}, True),
    ("laneclass", {"nn1_sparse": 30, "knn_classes": 6}, False),
    ("laneclass", {"nn1_dense": 30, "knn_classes": 7}, False),
    ("none", {"jv_solve": 1}, False),  # on the host nothing launches
    ("none", {"regularize_plane": 7}, False),
])
def test_launch_check(path, launches, ok):
    assert acc.launch_check(path, launches, linearizations=30, covariance_calls=7) is ok


@pytest.mark.parametrize("path, launches, ok", [
    ("none", {"jv_solve": 5, "regularize_plane": 7}, True),
    ("none", {"jv_solve": 5, "regularize_plane": 7, "nn1_sparse": 1}, False),
    ("none", {"jv_solve": 4, "regularize_plane": 7}, False),
    ("none", {"jv_solve": 5, "regularize_plane": 8}, False),
    ("none", {"jv_solve": 5}, False),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "jv_solve": 5, "regularize_plane": 7}, True),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "regularize_plane": 7}, False),
    ("laneclass", {"nn1_sparse": 30, "knn_classes": 7, "jv_solve": 5, "regularize_plane": 7}, True),
    ("laneclass", {"nn1_sparse": 30, "knn_classes": 7, "jv_solve": 6, "regularize_plane": 7}, False),
])
def test_launch_check_on_the_card(path, launches, ok):
    """On the card every path also launches ``jv_solve`` once per tracker
    update and ``regularize_plane`` once per covariance call."""
    assert acc.launch_check(path, launches, linearizations=30, covariance_calls=7, tracker_updates=5) is ok


@pytest.mark.parametrize("leg", ["gpu_default", "gpu_exact", "gpu_exact_hulls", "gpu_laneclass"])
def test_card_legs_raise_without_a_card(leg):
    seq = _seq(n=2)
    with pytest.raises(RuntimeError, match="CUDA card"):
        acc.run_leg(leg, port_cfg(lean_cfg(seq)), seq)


def test_host_leg_equals_replay_and_restores_the_environment(monkeypatch):
    seq = _seq(n=3)
    cfg = port_cfg(lean_cfg(seq))
    monkeypatch.setenv("DDLO_NN_IMPL", "pallas")
    monkeypatch.delenv("DDLO_KNN_IMPL", raising=False)
    seen = []
    real = runner.replay

    def replay(*a, **kw):
        seen.append({k: os.environ.get(k) for k in acc.IMPL_VARS})
        return real(*a, **kw)

    monkeypatch.setattr(runner, "replay", replay)
    rec = acc.run_leg("port_cpu_exact", cfg, seq)
    assert seen == [acc.EXACT]
    assert os.environ["DDLO_NN_IMPL"] == "pallas" and "DDLO_KNN_IMPL" not in os.environ

    monkeypatch.setenv("DDLO_NN_IMPL", "exact")
    monkeypatch.setenv("DDLO_KNN_IMPL", "exact")
    res = real(cfg, seq, hulls="device", device="cpu")
    np.testing.assert_array_equal(rec["poses"], res.poses)
    np.testing.assert_array_equal(rec["quats"], res.quats)
    np.testing.assert_array_equal(rec["stamps"], res.stamps)
    assert (rec["num_keyframes"], rec["map_points"], rec["dropped"]) == (
        res.num_keyframes, res.map_points, res.dropped_scans)
    assert rec["ate"] == metrics.ate_rmse(res.poses, seq.gt_poses, res.stamps, seq.stamps)
    assert len(rec["keyframe_added"]) == 2 and rec["linearizations"] >= 2 * 3
    assert rec["launches"] == {} and rec["launch_check"]
    assert rec["tracker_updates"] == 2 and rec["jv_host_reads"] > 0
    assert rec["covariance_calls"] >= 2 + 2  # init (scan and keyframe), one per scan
    assert rec["total_ms_per_scan"]["n"] == res.profiler["total"].n

"""Full DDLO (dynamic detection on) end to end: the port's
pipeline.init_state / pipeline.step against the JAX package's.

Bars, every scan: translation within 1e-3 m, rotation within 1e-3 rad,
the same keyframe-added flags, the same valid detection slots, box states
within 1e-3 and the same track statuses.

(a) exact CPU paths on both sides, tests/test_odometry.py's small_cfg,
    8 scans;
(b) the accelerator paths: tests/test_torch_pipeline_dynamic_accel.py;
(c) the golden trajectories tests/golden/linear_32x512_seed7.npz and
    spherical_32x512_seed7.npz, the scene built through the port's own
    ``io.synthetic``: within 5e-3 m
    where the golden is near the true pose, held to the truth at the one
    scan where the golden is a rounding-decided outlier; and, scan by
    scan, one port step from the JAX state against the JAX output;
(d) the state bridge: a JAX mid-sequence state, tracker included,
    round-trips through ``interop`` and one dynamic step from it agrees.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (
    assert_ddlo_parity, n, port_cfg, render_seq, rot_err, run_jax_ddlo, run_port_ddlo, small_cfg,
)

from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
from dynamic_direct_lidar_odometry_tpu_torch import interop, pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "linear_32x512_seed7.npz")
SPHERICAL_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "spherical_32x512_seed7.npz")

@pytest.fixture(scope="module")
def dyn_run():
    """8 rendered scans and the JAX CPU run of full DDLO at small_cfg."""
    cfg = small_cfg()
    assert cfg.dynamic_detection
    _, _, scans = render_seq(cfg, 8)
    j_states, j_outs = run_jax_ddlo(cfg, scans)
    return cfg, scans, j_states, j_outs


def test_ddlo_exact_paths_match_jax(dyn_run):
    cfg, scans, j_states, j_outs = dyn_run
    p_states, p_outs = run_port_ddlo(cfg, scans)
    for js, jo, ps, po in zip(j_states, j_outs, p_states, p_outs):
        assert_ddlo_parity(jo, po, js, ps)
        np.testing.assert_array_equal(n(po.detections.labels), np.asarray(jo.detections.labels))
        np.testing.assert_array_equal(n(po.non_static_mask), np.asarray(jo.non_static_mask))
    assert sum(int(np.asarray(o.detections.objects.valid).sum()) for o in j_outs) > 10
    assert any(bool(o.keyframe_added) for o in p_outs)


# The golden scene's scan 6 is where the reference itself misconverges:
# the sensor sits at ground level, z is weakly constrained, and the JAX
# run that wrote the golden landed at z = 0.20 m where the true pose has
# z = 0 (S2M takes 8 LM iterations there against 2-3 elsewhere). Which
# basin a run falls into at that scan is decided by rounding: a few
# near-collinear neighborhoods whose PLANE normal turns on one ulp
# (tests/test_torch_golden_rounding.py), and ``torch.sqrt`` of an f32 CPU
# tensor, which that normal passes through, is up to 0.74 ulp off on
# some hosts (ROADMAP queue 3). The port has landed at z = 0.203 (the
# golden's basin), 0.177 and 0.025 (next to the truth) from states that
# agree to 1e-4 m, and the JAX package itself lands 4.76e-3 m from its own
# golden there. So no implementation can be held to the golden's value at
# that scan on every host. Everywhere else the golden is within 5e-2 m of
# the truth.
GOLDEN_OUTLIER_M = 5e-2
GOLDEN_ATOL_M = 5e-3  # the JAX golden test's own bar (tests/test_golden.py)
LOCKSTEP_OUTLIER_MARGIN_M = 2.5e-2  # the spread of the z = 0.18-0.20 basin


def _golden_scene():
    """tests/golden_scenes.py's scene through the port's own synthetic:
    10 rendered scans and their true poses."""
    from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic

    world = synthetic.World.town(seed=7, n_static=10)
    mov = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]),
                         np.array([1.0, 0.3, 0.0]))]
    rng = np.random.default_rng(0)
    scans, truth = [], []
    for i in range(10):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.03 * i, 0.0]
        T[0, 0] = T[1, 1] = np.cos(th)
        T[0, 1] = -np.sin(th)
        T[1, 0] = np.sin(th)
        scans.append(synthetic.render_scan(world, T, H=32, W=512, t=0.1 * i, extra_boxes=mov, rng=rng))
        truth.append(T[:3, 3])
    return scans, np.array(truth)


def _no_farther_from_truth(pose, ref_pose, truth, margin=GOLDEN_ATOL_M):
    """Per axis, ``pose`` is no farther from the true pose than the
    reference's own pose is, plus ``margin``."""
    assert np.all(np.abs(pose - truth) <= np.abs(ref_pose - truth) + margin), (pose, ref_pose, truth)


def test_port_reproduces_the_golden_trajectory():
    """ROADMAP milestone (b), organized layout: tests/golden_scenes.py's
    scene and replay, through the port (and its own synthetic).

    Held on every host: on the scans where the golden is itself within
    5e-2 m of the true pose (all but scan 6) the port lands within the
    JAX golden test's 5e-3 m of the golden, so the trajectory re-joins it
    on scans 7-9; at scan 6, where the golden is 0.20 m off in z (see
    above), the port's pose is no farther from the true pose than the
    golden's is, per axis, plus 5e-3 (it fell into the golden's basin on
    one host, 4.75e-3 m from it, and landed next to the truth, 0.18 m
    from the golden, on another)."""
    from golden_scenes import golden_cfg

    cfg = port_cfg(golden_cfg(organized=True))
    scans, truth = _golden_scene()
    st = pipeline.init_state(cfg, *scans[0], 0.0, device="cpu")
    poses = []
    for i in range(1, 10):
        st, out = pipeline.step(cfg, st, *scans[i], 0.1 * i)
        poses.append(n(out.odom.pose))
    poses, golden = np.array(poses), np.load(GOLDEN)["poses"]
    outlier = np.abs(golden - truth[1:]).max(axis=1) > GOLDEN_OUTLIER_M
    assert np.flatnonzero(outlier).tolist() == [5]  # scan 6
    np.testing.assert_allclose(poses[~outlier], golden[~outlier], atol=GOLDEN_ATOL_M)
    _no_farther_from_truth(poses[5], golden[5], truth[6])


def test_port_reproduces_the_spherical_golden_trajectory():
    """ROADMAP milestone (b), spherical layout
    (tests/golden/spherical_32x512_seed7.npz, ``golden_cfg(organized=False)``):
    the same scene through the port's ``point_index`` scatter of the
    per-pixel slots back to the source points (the projection is not the
    identity here), held with the organized test's rules: 5e-3 m where the
    golden is within 5e-2 m of the truth, and at its outlier scan no
    farther from the truth than the golden, per axis, plus 5e-3."""
    from golden_scenes import golden_cfg

    cfg = port_cfg(golden_cfg(organized=False))
    scans, truth = _golden_scene()
    st = pipeline.init_state(cfg, *scans[0], 0.0, device="cpu")
    poses = []
    for i in range(1, 10):
        st, out = pipeline.step(cfg, st, *scans[i], 0.1 * i)
        poses.append(n(out.odom.pose))
        pidx = n(out.detections.point_index).reshape(-1)
        assert not np.array_equal(pidx, np.arange(pidx.size))  # the scatter ran
    poses, golden = np.array(poses), np.load(SPHERICAL_GOLDEN)["poses"]
    outlier = np.abs(golden - truth[1:]).max(axis=1) > GOLDEN_OUTLIER_M
    assert np.flatnonzero(outlier).tolist() == [5]  # scan 6
    np.testing.assert_allclose(poses[~outlier], golden[~outlier], atol=GOLDEN_ATOL_M)
    _no_farther_from_truth(poses[5], golden[5], truth[6])


@pytest.fixture(scope="module")
def golden_lockstep():
    """The golden scene through the JAX package on the CPU: the state
    before each of scans 1-9 (as numpy) and that scan's output."""
    from golden_scenes import golden_cfg

    jcfg = golden_cfg(organized=True)
    scans, truth = _golden_scene()
    st = jpipe.init_state(jcfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0)
    before, outs = [], []
    for i in range(1, 10):
        before.append(jax.tree.map(np.asarray, st))
        st, out = jpipe.step(jcfg, st, jnp.asarray(scans[i][0]), jnp.asarray(scans[i][1]),
                             jnp.float32(0.1 * i))
        outs.append(jax.tree.map(np.asarray, out))
    return port_cfg(jcfg), scans, truth, before, outs


@pytest.mark.parametrize("scan", range(1, 10))
def test_port_step_from_the_jax_state_matches_jax_on_the_golden_scene(golden_lockstep, scan):
    """The host-independent form of milestone (b): one ``pipeline.step``
    of the port from the JAX state before each scan of the golden scene
    (carried over by ``interop``) against the JAX output of that scan.
    No error accumulates over scans, so a host's rounding shows only as
    far as one step amplifies it.

    Bars: translation within 5e-3 m (the golden bar; measured 8e-5 to
    1.6e-3: what differs is the PLANE regularization of a few
    near-collinear neighborhoods, which the LM steps amplify), rotation
    within 2e-3 rad, the same keyframe flag and the same number of valid
    detections. At scan 6 (see above) the pose is held to the truth
    instead: no farther from it than the JAX pose is, per axis, plus
    2.5e-2 m, the spread of the basin both packages fall into from this
    state (measured: z = 0.203 m against JAX's 0.198 m, and 0.177 m with
    a correctly rounded square root in the PLANE regularization)."""
    cfg, scans, truth, before, outs = golden_lockstep
    jo = outs[scan - 1]
    state = interop.state_from_numpy(before[scan - 1], "cpu")
    _, po = pipeline.step(cfg, state, *scans[scan], 0.1 * scan)
    pose, jpose = n(po.odom.pose), jo.odom.pose
    if scan == 6:
        _no_farther_from_truth(pose, jpose, truth[scan], LOCKSTEP_OUTLIER_MARGIN_M)
    else:
        np.testing.assert_allclose(pose, jpose, atol=GOLDEN_ATOL_M)
        assert rot_err(n(po.odom.T)[:3, :3], jo.odom.T[:3, :3]) < 2e-3
    assert bool(po.keyframe_added) == bool(jo.keyframe_added)
    assert int(po.detections.objects.valid.sum()) == int(jo.detections.objects.valid.sum())


def test_state_bridge_round_trip_and_one_dynamic_step(dyn_run):
    cfg, scans, j_states, j_outs = dyn_run
    k = 4  # the state after scan 5: tracks alive, a warm hull cache
    j_np = jax.tree.map(np.asarray, j_states[k])
    assert j_np.tracks.active.any()
    p_state = interop.state_from_numpy(j_np, "cpu")
    back = interop.state_to_numpy(p_state)
    leaves_j, leaves_b = jax.tree.leaves(j_np), jax.tree.leaves(back)
    assert len(leaves_j) == len(leaves_b)
    for a, b in zip(leaves_j, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the outputs bridge too: a JAX DetectionResult into the port's class
    det = interop.state_from_numpy(jax.tree.map(np.asarray, j_outs[k].detections), "cpu")
    assert type(det).__name__ == "DetectionResult"
    np.testing.assert_array_equal(n(det.pixel_slot), np.asarray(j_outs[k].detections.pixel_slot))
    p_states, p_outs = run_port_ddlo(cfg, scans[: k + 3], state=p_state, start=k + 2)
    assert_ddlo_parity(j_outs[k + 1], p_outs[0], j_states[k + 1], p_states[0])

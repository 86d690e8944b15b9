"""Full DDLO (dynamic detection on) end to end: the port's
pipeline.init_state / pipeline.step against the JAX package's.

Bars, every scan: translation within 1e-3 m, rotation within 1e-3 rad,
the same keyframe-added flags, the same valid detection slots, box states
within 1e-3 and the same track statuses.

(a) exact CPU paths on both sides, tests/test_odometry.py's small_cfg,
    8 scans;
(b) the accelerator paths: tests/test_torch_pipeline_dynamic_accel.py;
(c) the golden trajectory tests/golden/linear_32x512_seed7.npz, its
    scene built through the port's own ``io.synthetic``, within 1e-2 m
    (see the test for why not 5e-3);
(d) the state bridge: a JAX mid-sequence state, tracker included,
    round-trips through ``interop`` and one dynamic step from it agrees.
"""

import os

import jax
import numpy as np
import pytest

from torch_parity import (
    assert_ddlo_parity, n, port_cfg, render_seq, run_jax_ddlo, run_port_ddlo, small_cfg,
)

from dynamic_direct_lidar_odometry_tpu_torch import interop, pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "linear_32x512_seed7.npz")

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


def test_port_reproduces_the_golden_trajectory():
    """ROADMAP milestone (b), organized layout: tests/golden_scenes.py's
    scene and replay, through the port (and its own synthetic).

    Bar 1e-2 m, not the JAX golden test's 5e-3: this scene's sensor sits
    at ground level, so z is weakly constrained and the LM step
    amplifies rounding. The JAX package itself now lands 4.8e-3 from its
    own golden at one scan; one port step from the identical JAX state
    moves z by 2.7 mm: with identical neighbor sets, the near-collinear
    neighborhoods' normals (eigenvalues ~0, 1e-4, 0.8) are decided by
    rounding, and a few covariances change. The port's largest miss is
    8.0e-3 m."""
    from golden_scenes import golden_cfg

    from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic

    cfg = port_cfg(golden_cfg(organized=True))
    world = synthetic.World.town(seed=7, n_static=10)
    mov = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]),
                         np.array([1.0, 0.3, 0.0]))]
    rng = np.random.default_rng(0)
    pts, mask = synthetic.render_scan(world, np.eye(4), H=32, W=512, t=0.0, extra_boxes=mov, rng=rng)
    st = pipeline.init_state(cfg, pts, mask, 0.0, device="cpu")
    poses = []
    for i in range(1, 10):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.03 * i, 0.0]
        T[0, 0] = T[1, 1] = np.cos(th)
        T[0, 1] = -np.sin(th)
        T[1, 0] = np.sin(th)
        pts, mask = synthetic.render_scan(world, T, H=32, W=512, t=0.1 * i, extra_boxes=mov, rng=rng)
        st, out = pipeline.step(cfg, st, pts, mask, 0.1 * i)
        poses.append(n(out.odom.pose))
    np.testing.assert_allclose(np.array(poses), np.load(GOLDEN)["poses"], atol=1e-2)


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

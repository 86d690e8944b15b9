"""The plain-DLO slice end to end: the port's pipeline.init_state /
pipeline.step against the JAX package's at tests/test_odometry.py's
small_cfg with dynamic_detection=False.

Bars (every scan): translation within 1e-3 m, rotation within 1e-3 rad,
the same keyframe-added flags and the same store.valid.

(a) exact CPU paths on both sides, 8 scans;
(b) accelerator paths (port: forced on CPU tensors, so the sparse
    kernel's plain version and the window covariances run; JAX: backend
    patched to "tpu", Pallas interpreted), 3 scans;
(c) the state bridge: a JAX mid-sequence state round-trips bit-exactly
    through state_from_numpy / state_to_numpy, and one step from it
    agrees in both implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    jax_tpu_paths, n, plain_cfg, port_accelerator_paths, port_cfg, render_seq, rot_err, tpu_cfg,
)

from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
from dynamic_direct_lidar_odometry_tpu_torch import interop, pipeline


def _run_jax(cfg, scans, state=None, start=1):
    if state is None:
        state = jpipe.init_state(cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0)
    outs, states = [], []
    for i in range(start, len(scans)):
        pts, m = scans[i]
        state, out = jpipe.step(cfg, state, jnp.asarray(pts), jnp.asarray(m), jnp.float32(0.1 * i))
        outs.append(out)
        states.append(state)
    return states, outs


def _run_port(cfg, scans, state=None, start=1):
    """Returns per-scan store.valid snapshots, not states: the port
    writes the keyframe store in place, so an earlier state's store
    shows later inserts."""
    pcfg = port_cfg(cfg)
    if state is None:
        state = pipeline.init_state(pcfg, scans[0][0], scans[0][1], 0.0, device="cpu")
    outs, valids = [], []
    for i in range(start, len(scans)):
        pts, m = scans[i]
        state, out = pipeline.step(pcfg, state, pts, m, 0.1 * i)
        outs.append(out)
        valids.append(n(state.odom.store.valid).copy())
    return valids, outs


def _assert_scan_parity(j_out, p_out, j_state, p_valid):
    jT, pT = np.asarray(j_out.odom.T), n(p_out.odom.T)
    assert np.abs(pT[:3, 3] - jT[:3, 3]).max() < 1e-3
    assert rot_err(pT[:3, :3], jT[:3, :3]) < 1e-3
    assert bool(p_out.keyframe_added) == bool(j_out.keyframe_added)
    np.testing.assert_array_equal(p_valid, np.asarray(j_state.odom.store.valid))
    assert bool(p_out.odom.s2m_converged) and bool(j_out.odom.s2m_converged)


@pytest.fixture(scope="module")
def plain_run():
    """8 rendered scans (raw: NaN in invalid pixels) and the JAX CPU run."""
    cfg = plain_cfg()
    _, _, scans = render_seq(cfg, 8)
    j_states, j_outs = _run_jax(cfg, scans)
    return cfg, scans, j_states, j_outs


def test_slice_exact_paths_match_jax(plain_run):
    cfg, scans, j_states, j_outs = plain_run
    p_valids, p_outs = _run_port(cfg, scans)
    for js, jo, pv, po in zip(j_states, j_outs, p_valids, p_outs):
        _assert_scan_parity(jo, po, js, pv)
    assert any(bool(o.keyframe_added) for o in p_outs)  # the store moved
    out = p_outs[-1]  # DDLOOutputs of the plain branch: JAX shapes, empty perception
    jo = j_outs[-1]
    for name in ("static_points", "static_mask", "dynamic_mask", "ground_mask"):
        assert tuple(getattr(out, name).shape) == np.asarray(getattr(jo, name)).shape
    assert tuple(out.detections.pixel_slot.shape) == jo.detections.pixel_slot.shape
    assert tuple(out.tracks.matched.shape) == jo.tracks.matched.shape


def test_slice_accelerator_paths_match_jax():
    cfg = tpu_cfg()
    _, _, scans = render_seq(cfg, 4)
    with jax_tpu_paths():
        j_states, j_outs = _run_jax(cfg, scans)
    with port_accelerator_paths():
        p_valids, p_outs = _run_port(cfg, scans)
    for js, jo, pv, po in zip(j_states, j_outs, p_valids, p_outs):
        _assert_scan_parity(jo, po, js, pv)
    # the 3x-dilated sparse residual pass clamps at 3 * max_corr_dist
    res = n(p_outs[-1].odom.residuals)
    assert res.max() <= 3.0 * cfg.gicp.s2m.max_correspondence_distance


def test_state_bridge_round_trip_and_one_step(plain_run):
    cfg, scans, j_states, j_outs = plain_run
    k = 4  # the state after scan 5: two keyframes, a warm hull cache
    j_np = jax.tree.map(np.asarray, j_states[k])
    p_state = interop.state_from_numpy(j_np, "cpu")
    back = interop.state_to_numpy(p_state)
    leaves_j, leaves_b = jax.tree.leaves(j_np), jax.tree.leaves(back)
    assert len(leaves_j) == len(leaves_b)
    for a, b in zip(leaves_j, leaves_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert isinstance(p_state.odom.store.points, torch.Tensor)
    # one step from the same state in both implementations (scan k + 2)
    p_valids, p_outs = _run_port(cfg, scans[: k + 3], state=p_state, start=k + 2)
    _assert_scan_parity(j_outs[k + 1], p_outs[0], j_states[k + 1], p_valids[0])


def test_dynamic_detection_and_sharding_raise(plain_run):
    """Dynamic detection is ported (init_state accepts it and returns an
    empty tracker); point-parallel sharding raises when it is given a mesh
    axis name, not the mesh's process group (tests/test_torch_point_parallel.py
    runs it)."""
    import dataclasses

    cfg, scans, j_states, _ = plain_run
    dyn = port_cfg(dataclasses.replace(cfg, dynamic_detection=True))
    st = pipeline.init_state(dyn, scans[0][0], scans[0][1], device="cpu")
    assert not bool(st.tracks.active.any())
    state = interop.state_from_numpy(jax.tree.map(np.asarray, j_states[0]), "cpu")
    with pytest.raises(ValueError, match="pt process group"):
        pipeline.step(port_cfg(cfg), state, scans[1][0], scans[1][1], 0.1, axis_name="pt", pt_size=2)


@pytest.mark.parametrize("extrinsic", [None, (0.7071068, 0.0, 0.0, -0.7071068)])
def test_gravity_align_matches_jax(extrinsic):
    from dynamic_direct_lidar_odometry_tpu.odometry import odometry as jodo
    from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry

    rng = np.random.default_rng(3)
    acc = np.array([0.3, -0.4, 9.7]) + rng.normal(0, 0.05, (1000, 3))
    np.testing.assert_allclose(
        odometry.gravity_align(acc, extrinsic), jodo.gravity_align(acc, extrinsic), atol=1e-6
    )

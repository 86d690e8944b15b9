"""Tracking modules of the port against the JAX package on the CPU:
``kalman.predict`` / ``update``, ``hungarian.assign`` (against JAX and
against scipy on the cases of tests/test_assignment.py) and
``tracker.update`` over a scripted detection sequence.

Bars: assignments, statuses, hits, ids, slots, masks and every other
integer or boolean field equal; float fields (KF state and covariance,
boxes) within 1e-5 relative and absolute: the f32 7x7 solve and the
matrix products round in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, port_cfg, t

from dynamic_direct_lidar_odometry_tpu.config import TrackingConfig
from dynamic_direct_lidar_odometry_tpu.ops import hungarian as jhungarian
from dynamic_direct_lidar_odometry_tpu.ops import kalman as jkalman
from dynamic_direct_lidar_odometry_tpu.ops.bbox import Objects as JObjects
from dynamic_direct_lidar_odometry_tpu.tracking import tracker as jtracker
from dynamic_direct_lidar_odometry_tpu_torch import interop
from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, kalman
from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects
from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker


def test_kalman_predict_update_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 10)).astype(np.float32)
    A = rng.normal(size=(6, 10, 10)).astype(np.float32) * 0.3
    P = (A @ A.transpose(0, 2, 1) + np.eye(10, dtype=np.float32) * 2).astype(np.float32)
    y = rng.normal(size=(6, 7)).astype(np.float32)
    xj, Pj = jkalman.predict(jnp.asarray(x), jnp.asarray(P), jnp.float32(0.25))
    xp, Pp = kalman.predict(t(x), t(P), torch.tensor(0.25))
    np.testing.assert_allclose(n(xp), np.asarray(xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(Pp), np.asarray(Pj), rtol=1e-5, atol=1e-5)
    xj, Pj = jkalman.update(xj, Pj, jnp.asarray(y))
    xp, Pp = kalman.update(xp, Pp, t(y))
    np.testing.assert_allclose(n(xp), np.asarray(xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(Pp), np.asarray(Pj), rtol=1e-5, atol=1e-5)
    for name in ("initial_covariance", "process_noise", "measurement_noise", "measurement_matrix"):
        np.testing.assert_array_equal(n(getattr(kalman, name)()), np.asarray(getattr(jkalman, name)()))
    np.testing.assert_array_equal(
        n(kalman.transition_matrix(torch.tensor(0.1))), np.asarray(jkalman.transition_matrix(jnp.float32(0.1)))
    )


@pytest.mark.parametrize("n_,m,seed", [(5, 5, 0), (8, 8, 1), (3, 7, 2), (7, 3, 3)])
def test_assign_matches_scipy_and_jax(n_, m, seed):
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(seed)
    cost = rng.uniform(0, 10, (n_, m)).astype(np.float32)
    rv, cv = np.ones(n_, bool), np.ones(m, bool)
    col = n(hungarian.assign(t(cost), t(rv), t(cv)))
    np.testing.assert_array_equal(col, np.asarray(jhungarian.assign(*map(jnp.asarray, (cost, rv, cv)))))
    ri, ci = linear_sum_assignment(cost)
    assert (col >= 0).sum() == min(n_, m)
    np.testing.assert_allclose(sum(cost[r, c] for r, c in enumerate(col) if c >= 0),
                               cost[ri, ci].sum(), rtol=1e-5)


@pytest.mark.parametrize("seed", range(8))
def test_assign_masks_and_ties_match_jax(seed):
    """Masked rows/columns, integer costs with ties, and a valid last row
    with unassigned columns after it (where the JAX solve's final scatter
    lets an unassigned column overwrite the last row)."""
    rng = np.random.default_rng(100 + seed)
    R, C = rng.integers(3, 12, 2)
    cost = rng.uniform(0, 1, (R, C)).astype(np.float32)
    if seed % 2:
        cost = np.round(cost * 4).astype(np.float32)
    rv, cv = rng.uniform(size=R) > 0.3, rng.uniform(size=C) > 0.3
    rv[-1] = True
    j = np.asarray(jhungarian.assign(*map(jnp.asarray, (cost, rv, cv))))
    p = n(hungarian.assign(t(cost), t(rv), t(cv)))
    np.testing.assert_array_equal(p, j)
    assert np.all(p[~rv] == -1)


def _dets(specs, slots=8):
    """specs: (center, dims, avg_res, num_points) per valid slot."""
    state = np.zeros((slots, 7), np.float32)
    npts, res, valid = (np.zeros(slots, np.float32) for _ in range(3))
    for i, (c, d, r, k) in enumerate(specs):
        state[i, :3], state[i, 4:7] = c, d
        state[i, 3] = 0.1 * i
        npts[i], res[i], valid[i] = k, r, 1
    valid = valid.astype(bool)
    return JObjects(*map(jnp.asarray, (state, npts, npts, res, valid))), \
        Objects(*map(t, (state, npts, npts, res, valid)))


def _script():
    """Spawn, match, a velocity-gated jump, a parked object turning
    STATIC, a mover turning DYNAMIC with a clear-map emission, erasure."""
    box = (1.0, 1.0, 1.8)
    frames = []
    for k in range(14):
        specs = [((5.0, 5.0, 0.9), box, 0.5, 120)]  # sits still, high residuum
        if k >= 9:  # then moves 0.6 m per frame: STATIC -> DYNAMIC
            specs[0] = ((5.0 + 0.6 * (k - 8), 5.0, 0.9), box, 0.5, 120)
        if k < 6:
            specs.append(((0.4 * k, -3.0, 0.9), box, 0.4, 90))  # a mover
        if k == 3:
            specs.append(((30.0, 0.0, 0.9), box, 0.4, 50))  # appears once
        if k == 4:
            specs.append(((40.0, 0.0, 0.9), box, 0.4, 50))  # a jump: no match
        if 2 <= k < 12:
            specs.append(((-6.0, 2.0, 0.9), (2.0, 1.0, 1.5), 0.0, 200))  # parked
        frames.append(specs)
    return frames


def test_tracker_update_matches_jax_over_a_script():
    cfg = TrackingConfig(max_no_hits=3, min_dynamic_hits=3, max_undefined_hits=5,
                         max_obj_velocity=15.0, min_dist_from_origin=0.75,
                         residuum_height_ratio=0.1)
    pcfg = port_cfg(cfg)
    js, ps = jtracker.empty_state(8), tracker.empty_state(8, device="cpu")
    seen = set()
    for specs in _script():
        jd, pd = _dets(specs)
        js, jo = jtracker.update(cfg, js, jd, jnp.float32(0.1))
        ps, po = tracker.update(pcfg, ps, pd, torch.tensor(0.1))
        for name, a, b in zip(js._fields, js, interop.state_to_numpy(ps)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(b, a, err_msg=name)
        for name, a, b in zip(jo._fields, jo, interop.state_to_numpy(po)):
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-5, err_msg=name)
        act = np.asarray(js.active)
        seen |= set(np.asarray(js.status)[act].tolist())
        if np.asarray(jo.clear_map_valid).any():
            seen.add("clear_map")
        mask = n(tracker.status_detection_mask(ps, (tracker.UNDEFINED, tracker.DYNAMIC), 8))
        np.testing.assert_array_equal(
            mask, np.asarray(jtracker.status_detection_mask(js, (jtracker.UNDEFINED, jtracker.DYNAMIC), 8))
        )
    assert {tracker.UNDEFINED, tracker.STATIC, tracker.DYNAMIC, "clear_map"} <= seen
    assert int(ps.next_id) >= 5  # the jump spawned a new track

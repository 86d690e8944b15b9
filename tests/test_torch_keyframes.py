"""Keyframe store, exact on-device hulls and submap selection
(odometry/keyframes.py) against the JAX package: every output EQUAL."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_approximations import random_trajectory_positions
from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.odometry import keyframes as jkf
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf


def _insert_both(js, ts, pos, P, pts=None):
    pts = np.zeros((P, 3), np.float32) if pts is None else pts
    args = (np.asarray(pos, np.float32), np.array([1.0, 0, 0, 0], np.float32),
            pts, np.ones(P, bool), np.broadcast_to(np.eye(3, dtype=np.float32), (P, 3, 3)))
    js = jkf.add_keyframe(js, jnp.bool_(True), *map(jnp.asarray, args))
    ts = kf.add_keyframe(ts, True, *map(t, args))
    return js, ts


def _assert_store_equal(ts, js):
    for name in kf.KeyframeStore._fields:
        np.testing.assert_array_equal(n(getattr(ts, name)), np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("scene", ["square_with_interior", "collinear_sweep"])
def test_add_keyframe_eviction_matches_jax(scene):
    """Both eviction cases of tests/test_odometry.py: the farthest
    non-hull keyframe goes; with every keyframe on the hull, the farthest."""
    if scene == "square_with_interior":
        K, seq = 5, [[0, 0, 0], [20, 0, 0], [20, 20, 0], [0, 20, 0], [10, 10, 0], [1, 1, 0]]
    else:
        K, seq = 4, [[float(i), 0, 0] for i in range(8)]
    js, ts = jkf.empty_store(K, 4), kf.empty_store(K, 4, device="cpu")
    for pos in seq:
        js, ts = _insert_both(js, ts, pos, 4)
        _assert_store_equal(ts, js)
    assert int(ts.count) - K == int(jkf.overflow_count(js))  # accepted past capacity


def test_add_keyframe_no_add_is_identity():
    ts = kf.empty_store(3, 4, device="cpu")
    before = kf.clone_store(ts)
    out = kf.add_keyframe(ts, False, torch.ones(3), torch.tensor([1.0, 0, 0, 0]),
                          torch.ones(4, 3), torch.ones(4, dtype=torch.bool), torch.eye(3).expand(4, 3, 3))
    # a copy (the single control.cond path), every field equal to the store
    for a, b, c in zip(out, ts, before):
        assert torch.equal(a, c) and torch.equal(b, c)
    assert int(out.count) == 0


def _hull_scenes():
    scenes = []
    for seed in range(4):  # tests/test_approximations.py trajectories
        scenes.append((f"traj{seed}", random_trajectory_positions(40, seed), np.ones(40, bool), 5.0))
    for seed in range(3):  # dense/blocked-equivalence scenes, partly valid
        rng = np.random.default_rng(seed)
        pos = rng.uniform(-20, 20, (48, 3)).astype(np.float32)
        scenes.append((f"uniform{seed}", pos, np.arange(48) < int(rng.integers(6, 49)),
                       float(rng.uniform(3, 12))))
    sq = np.array([[0, 0, 0], [4, 0, 0], [4, 4, 0], [0, 4, 0], [2, 2, 0]], np.float32)
    scenes.append(("coplanar_square", sq, np.ones(5, bool), 3.0))
    line = np.stack([np.arange(6), np.zeros(6), np.zeros(6)], 1).astype(np.float32)
    scenes.append(("collinear", line, np.ones(6, bool), 3.0))
    grid = np.stack(np.meshgrid(np.arange(4.0), np.arange(4.0)), -1).reshape(-1, 2)
    scenes.append(("cocircular_grid", np.column_stack([grid, np.zeros(16)]).astype(np.float32),
                   np.ones(16, bool), 1.0))
    rng = np.random.default_rng(64)
    pos64 = random_trajectory_positions(64, 11)
    scenes.append(("store64", pos64, rng.uniform(size=64) < 0.8, 4.0))
    return scenes


SCENES = {s[0]: s[1:] for s in _hull_scenes()}
# jitted: one compile per store size instead of eager op-by-op dispatch
_jax_convex = jax.jit(jkf._convex_hull_mask_dense)
_jax_concave = jax.jit(jkf._concave_hull_mask_dense)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_dense_hull_masks_match_jax(scene):
    pos, valid, alpha = SCENES[scene]
    jcv = np.asarray(_jax_convex(jnp.asarray(pos), jnp.asarray(valid)))
    jcc = np.asarray(_jax_concave(jnp.asarray(pos), jnp.asarray(valid), jnp.float32(alpha)))
    np.testing.assert_array_equal(n(kf.convex_hull_mask(t(pos), t(valid))), jcv)
    np.testing.assert_array_equal(
        n(kf.concave_hull_mask(t(pos), t(valid), torch.tensor(alpha, dtype=torch.float32))), jcc
    )


def _filled_stores(K=16, P=32, n_kf=12, seed=0):
    """The same store in both packages: keyframes along a trajectory with
    front-packed clouds of different valid counts."""
    rng = np.random.default_rng(seed)
    js, ts = jkf.empty_store(K, P), kf.empty_store(K, P, device="cpu")
    pos = random_trajectory_positions(n_kf, seed, scale=15.0)
    for i in range(n_kf):
        nv = int(rng.integers(P // 4, P + 1))
        pts = np.full((P, 3), 1.0e6, np.float32)
        pts[:nv] = pos[i] + rng.normal(0, 1, (nv, 3))
        mask = np.arange(P) < nv
        covs = np.broadcast_to(np.eye(3, dtype=np.float32) * (i + 1), (P, 3, 3)).copy()
        args = (pos[i], np.array([1.0, 0, 0, 0], np.float32), pts, mask, covs)
        js = jkf.add_keyframe(js, jnp.bool_(True), *map(jnp.asarray, args))
        ts = kf.add_keyframe(ts, True, *map(t, args))
    return js, ts


@pytest.fixture(scope="module")
def stores():
    return _filled_stores()  # read-only below


@pytest.mark.parametrize("knn,kcv,kcc", [(2, 2, 2), (4, 3, 3), (10, 10, 10)])
def test_select_submap_matches_jax(stores, knn, kcv, kcc):
    js, ts = stores
    cur = np.array([3.0, -2.0, 0.1], np.float32)
    want = np.asarray(jkf.select_submap(js, jnp.asarray(cur), jnp.float32(6.0), knn, kcv, kcc))
    got = n(kf.select_submap(ts, t(cur), torch.tensor(6.0), knn, kcv, kcc))
    np.testing.assert_array_equal(got, want)
    # given hull masks take precedence over the on-device hulls
    cv = np.arange(16) % 3 == 0
    want = np.asarray(jkf.select_submap(js, jnp.asarray(cur), jnp.float32(6.0), knn, kcv, kcc,
                                        cv_mask=jnp.asarray(cv), cc_mask=jnp.asarray(~cv)))
    got = n(kf.select_submap(ts, t(cur), torch.tensor(6.0), knn, kcv, kcc,
                             cv_mask=t(cv), cc_mask=t(~cv)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_slots,capacity", [(8, 160), (8, 100), (16, None), (5, 512)])
def test_gather_submap_matches_jax(stores, max_slots, capacity):
    js, ts = stores
    sel = np.zeros(16, bool)
    sel[[0, 2, 3, 5, 7, 8, 9, 11, 13]] = True  # 13 is an empty slot
    want = jkf.gather_submap(js, jnp.asarray(sel), max_slots, capacity=capacity)
    got = kf.gather_submap(ts, t(sel), max_slots, capacity=capacity)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), np.asarray(w))


def test_gather_submap_over_capacity_drops_tail_like_jax():
    """tests/test_odometry.py's overflow case: 16 valid points, room for 10."""
    js, ts = jkf.empty_store(2, 8), kf.empty_store(2, 8, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(2):
        js, ts = _insert_both(js, ts, [0, 0, 0], 8, rng.uniform(-5, 5, (8, 3)).astype(np.float32))
    sel = np.array([True, True])
    want = jkf.gather_submap(js, jnp.asarray(sel), max_slots=2, capacity=10)
    got = kf.gather_submap(ts, t(sel), max_slots=2, capacity=10)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(n(g), np.asarray(w))
    assert int(got[1].sum()) == 10

"""The port's global map (mapping/mapper.py) against the JAX package's
on the same numpy inputs: points and masks EQUAL (ring writes, box
removal), voxel centroids to fp32 summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.mapping import mapper as jmapper
from dynamic_direct_lidar_odometry_tpu_torch.mapping import mapper

CENTROID_ATOL = 2e-5  # fp32 centroid sums in another order, |x| <= 40


def _assert_map_equal(pm, jm, atol=0.0):
    np.testing.assert_array_equal(n(pm.mask), np.asarray(jm.mask))
    np.testing.assert_allclose(n(pm.points), np.asarray(jm.points), atol=atol, rtol=0)
    for f in ("write_ptr", "total_added"):
        assert getattr(pm, f).dtype == torch.int32
        assert int(getattr(pm, f)) == int(getattr(jm, f)), f


def _cloud(rng, P, lo, hi, keep=0.8):
    pts = rng.uniform(lo, hi, (P, 3)).astype(np.float32)
    return pts, rng.uniform(size=P) < keep


@pytest.mark.parametrize("use_voxel_filter", [True, False])
def test_add_keyframe_ring_matches_jax(use_voxel_filter):
    """Several inserts into a small ring: it wraps twice."""
    rng = np.random.default_rng(0)
    C = 300
    jm, pm = jmapper.empty_map(C), mapper.empty_map(C, device="cpu")
    for i in range(5):
        pts, msk = _cloud(rng, 128, i * 10.0, i * 10.0 + 8.0)
        jm = jmapper.add_keyframe(jm, jnp.asarray(pts), jnp.asarray(msk), 0.5,
                                  use_voxel_filter=use_voxel_filter)
        pm = mapper.add_keyframe(pm, t(pts), t(msk), 0.5, use_voxel_filter=use_voxel_filter)
        _assert_map_equal(pm, jm, CENTROID_ATOL if use_voxel_filter else 0.0)
    assert int(pm.total_added) > C
    assert int(mapper.num_points(pm)) == int(jmapper.num_points(jm)) == C


@pytest.mark.parametrize("ptr", [0, 37])
def test_keyframe_larger_than_the_map(ptr):
    """More valid points than the capacity: the JAX scatter leaves the
    last C of them, wrapped from the cursor; so must the port."""
    rng = np.random.default_rng(1)
    C = 100
    jm, pm = jmapper.empty_map(C), mapper.empty_map(C, device="cpu")
    if ptr:
        pts, msk = rng.uniform(-5, 5, (ptr, 3)).astype(np.float32), np.ones(ptr, bool)
        jm = jmapper.add_keyframe(jm, jnp.asarray(pts), jnp.asarray(msk), 0.1, use_voxel_filter=False)
        pm = mapper.add_keyframe(pm, t(pts), t(msk), 0.1, use_voxel_filter=False)
    pts, msk = _cloud(rng, 400, -20, 20, keep=0.7)
    assert msk.sum() > C
    jm = jmapper.add_keyframe(jm, jnp.asarray(pts), jnp.asarray(msk), 0.1, use_voxel_filter=False)
    pm = mapper.add_keyframe(pm, t(pts), t(msk), 0.1, use_voxel_filter=False)
    _assert_map_equal(pm, jm)
    assert n(pm.mask).all()


def test_add_keyframe_leaves_its_argument():
    pm = mapper.empty_map(50, device="cpu")
    before = n(pm.points).copy()
    mapper.add_keyframe(pm, torch.ones(8, 3), torch.ones(8, dtype=torch.bool), 0.1)
    np.testing.assert_array_equal(n(pm.points), before)
    assert not n(pm.mask).any()


def _boxes_and_points(rng, T=6, H=5, P=3000, margin=0.3):
    """(T, H, 7) box histories [cx, cy, cz, sin(yaw/2), l, w, h] with
    yaws, some invalid, and map points none of which lies within 1e-3 m
    of a (margin-grown) box face in float64."""
    boxes = np.zeros((T, H, 7), np.float32)
    boxes[..., :2] = rng.uniform(-8, 8, (T, H, 2))
    boxes[..., 2] = rng.uniform(0.5, 1.5, (T, H))
    boxes[..., 3] = np.sin(rng.uniform(-np.pi, np.pi, (T, H)) / 2)
    boxes[..., 4:7] = rng.uniform(0.8, 3.0, (T, H, 3))
    valid = rng.uniform(size=(T, H)) < 0.6
    pts = rng.uniform(-10, 10, (P, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.5, 3.0, P)
    b = boxes.reshape(-1, 7).astype(np.float64)
    yaw = 2 * np.arcsin(b[:, 3])
    c, s = np.cos(-yaw), np.sin(-yaw)
    d = pts[None].astype(np.float64) - b[:, None, :3]
    local = np.stack([c[:, None] * d[..., 0] - s[:, None] * d[..., 1],
                      s[:, None] * d[..., 0] + c[:, None] * d[..., 1], d[..., 2]], -1)
    half = b[:, None, 4:7] * 0.5 + margin
    near_face = np.any(np.abs(np.abs(local) - half) < 1e-3, axis=(0, 2))
    return boxes, valid, pts[~near_face]


@pytest.mark.parametrize("margin", [0.0, 0.3])
def test_remove_boxes_matches_jax(margin):
    rng = np.random.default_rng(2)
    boxes, valid, pts = _boxes_and_points(rng, margin=margin)
    C = len(pts) + 50  # a free tail of SENTINEL rows
    jm, pm = jmapper.empty_map(C), mapper.empty_map(C, device="cpu")
    msk = np.ones(len(pts), bool)
    jm = jmapper.add_keyframe(jm, jnp.asarray(pts), jnp.asarray(msk), 0.1, use_voxel_filter=False)
    pm = mapper.add_keyframe(pm, t(pts), t(msk), 0.1, use_voxel_filter=False)
    jm = jmapper.remove_boxes(jm, jnp.asarray(boxes), jnp.asarray(valid), margin=margin)
    pm = mapper.remove_boxes(pm, t(boxes), t(valid), margin=margin)
    _assert_map_equal(pm, jm)
    removed = len(pts) - int(mapper.num_points(pm))
    assert removed > 0
    # invalid boxes remove nothing
    all_in = mapper.remove_boxes(pm, t(boxes), torch.zeros(valid.shape, dtype=torch.bool), margin=margin)
    np.testing.assert_array_equal(n(all_in.mask), n(pm.mask))


def test_remove_boxes_chunks_give_the_same_mask(monkeypatch):
    """Chunks of 7 boxes instead of all at once: the same mask."""
    rng = np.random.default_rng(3)
    boxes, valid, pts = _boxes_and_points(rng)
    pm = mapper.add_keyframe(mapper.empty_map(len(pts), device="cpu"), t(pts),
                             torch.ones(len(pts), dtype=torch.bool), 0.1, use_voxel_filter=False)
    whole = mapper.remove_boxes(pm, t(boxes), t(valid), margin=0.3)
    monkeypatch.setattr(mapper, "_BOX_CHUNK_ELEMS", 7 * len(pts))
    chunked = mapper.remove_boxes(pm, t(boxes), t(valid), margin=0.3)
    np.testing.assert_array_equal(n(chunked.mask), n(whole.mask))


def test_snapshot_and_num_points_match_jax():
    rng = np.random.default_rng(4)
    C = 2000
    jm, pm = jmapper.empty_map(C), mapper.empty_map(C, device="cpu")
    for i in range(3):
        pts, msk = _cloud(rng, 900, -15 + 3 * i, 15 + 3 * i)
        jm = jmapper.add_keyframe(jm, jnp.asarray(pts), jnp.asarray(msk), 0.05)
        pm = mapper.add_keyframe(pm, t(pts), t(msk), 0.05)
    assert int(mapper.num_points(pm)) == int(jmapper.num_points(jm))
    jp, jmask = jmapper.snapshot(jm, 1.0, C)
    pp, pmask = mapper.snapshot(pm, 1.0, C)
    np.testing.assert_array_equal(n(pmask), np.asarray(jmask))
    np.testing.assert_allclose(n(pp), np.asarray(jp), atol=CENTROID_ATOL, rtol=0)
    assert 0 < int(n(pmask).sum()) < int(mapper.num_points(pm))

"""Detection modules of the port against the JAX package, module by module
and end to end (``detection.detect``), on the CPU.

Bars: integer and boolean outputs (pixel rows/cols, point indices,
component labels, slot roots, pixel slots, validity, ground) equal;
ranges and residual images within 1e-5; segment residual means within
1e-6 (f32 summation order); IoUs within 1e-5. Box states: z extent and
point counts within 1e-4; the XY rectangle as a corner set within 1 cm,
because a wall's PCA frame is ill-conditioned (the f32 raw-moment
covariance of a 2 cm thick wall is rounding noise across it) and may
come out rotated by 180 degrees or by a few mrad in either package.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import golden_cfg
from torch_parity import (assert_boxes_match, camera_reference_labels, jax_objects_from_labels, n,
                          port_cfg, t)
from torch_segment_cases import blobs as _blobs
import torch_segment_cases

from dynamic_direct_lidar_odometry_tpu.detection import detection as jdetection
from dynamic_direct_lidar_odometry_tpu.io import synthetic
from dynamic_direct_lidar_odometry_tpu.ops import bbox as jbbox
from dynamic_direct_lidar_odometry_tpu.ops import projection as jprojection
from dynamic_direct_lidar_odometry_tpu.ops import segmentation as jsegmentation
from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
from dynamic_direct_lidar_odometry_tpu_torch.ops import bbox, projection, segmentation
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


def _scene(H=32, W=512, seed=7, T=None):
    """The golden scene of tests/golden_scenes.py: town seed 7, one mover."""
    world = synthetic.World.town(seed=seed, n_static=10)
    mov = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]),
                         np.array([1.0, 0.3, 0.0]))]
    if T is None:
        T = np.eye(4)
        T[:3, 3] = [0.3, 0.09, 0.0]
    pts, mask = synthetic.render_scan(world, T, H=H, W=W, t=0.3, extra_boxes=mov,
                                      rng=np.random.default_rng(0))
    return pts, mask, T.astype(np.float32)


def _world(pts, mask, T):
    w = np.nan_to_num(pts) @ T[:3, :3].T + T[:3, 3]
    return np.where(mask[:, None], w, 1.0e6).astype(np.float32)


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------


def test_project_organized_matches_jax():
    pts, mask, T = _scene(16, 128)
    w = _world(pts, mask, T)
    j = jprojection.project_organized(jnp.asarray(w), jnp.asarray(mask), jnp.asarray(T[:3, 3]), 16, 128, 1.0)
    p = projection.project_organized(t(w), t(mask), t(T[:3, 3]), 16, 128, 1.0)
    np.testing.assert_allclose(n(p.ranges), np.asarray(j.ranges), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(n(p.valid), np.asarray(j.valid))
    np.testing.assert_array_equal(n(p.points), np.asarray(j.points))
    np.testing.assert_array_equal(n(p.point_index), np.asarray(j.point_index))


def _colliding_cloud():
    """An unorganized cloud where many points share pixels: each ray
    direction appears 3 times at different ranges, in shuffled order."""
    rng = np.random.default_rng(4)
    az = rng.uniform(-np.pi, np.pi, 400)
    el = np.deg2rad(rng.uniform(-15, 15, 400))
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], -1)
    r = rng.uniform(2.0, 20.0, (3, 400, 1))
    pts = (d[None] * r).reshape(-1, 3)[rng.permutation(1200)].astype(np.float32)
    mask = rng.uniform(size=1200) > 0.1
    pts[rng.uniform(size=1200) < 0.05] *= 0.01  # some below minimum_range
    return pts, mask


def test_project_spherical_duplicate_pixels_pin_the_jax_winner():
    H, W = 16, 64
    pts, mask = _colliding_cloud()
    origin = np.array([0.5, -0.2, 0.1], np.float32)
    w = pts + origin
    j = jprojection.project_spherical(
        jnp.asarray(w), jnp.asarray(mask), jnp.asarray(pts), jnp.asarray(origin), H, W, 17.0, 1.0
    )
    p = projection.project_spherical(t(w), t(mask), t(pts), t(origin), H, W, 17.0, 1.0)
    jidx = np.asarray(j.point_index)
    # collisions happen, and the winner is the last point in cloud order
    row, col, fov = (np.asarray(x) for x in jprojection.lidar_grid_rowcol(jnp.asarray(pts), H, W, 17.0))
    assert np.bincount((row * W + col)[fov & mask]).max() >= 3
    np.testing.assert_array_equal(n(p.point_index), jidx)
    np.testing.assert_array_equal(n(p.valid), np.asarray(j.valid))
    np.testing.assert_array_equal(n(p.points), np.asarray(j.points))
    np.testing.assert_allclose(n(p.ranges), np.asarray(j.ranges), atol=1e-5, rtol=0)


@pytest.mark.parametrize("grid", ["lidar", "camera"])
def test_project_residuals_matches_jax(grid):
    H, W = 32, 128
    rng = np.random.default_rng(6)
    pts = rng.uniform(-10, 10, (3000, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5 if grid == "camera" else pts[:, 2] * 0.3
    res = rng.uniform(0, 2, 3000).astype(np.float32)
    m = rng.uniform(size=3000) > 0.2
    for fn in ("lidar_grid_rowcol", "camera_grid_rowcol"):
        args = (H, W, 20.0) if fn == "lidar_grid_rowcol" else (H, W)
        for a, b in zip(getattr(jprojection, fn)(jnp.asarray(pts), *args),
                        getattr(projection, fn)(t(pts), *args)):
            np.testing.assert_array_equal(n(b), np.asarray(a))
    j = jprojection.project_residuals(jnp.asarray(pts), jnp.asarray(res), jnp.asarray(m), H, W, 20.0, grid)
    p = projection.project_residuals(t(pts), t(res), t(m), H, W, 20.0, grid)
    assert (np.asarray(j) > 0).sum() > 100
    np.testing.assert_array_equal(n(p), np.asarray(j))


# ---------------------------------------------------------------------------
# ground removal + components
# ---------------------------------------------------------------------------


def test_ground_removal_matches_jax():
    T = np.eye(4)
    T[:3, 3] = [0.3, 0.09, 1.5]  # a sensor above the ground plane
    pts, mask, T = _scene(32, 256, T=T)
    ri = jprojection.project_organized(jnp.asarray(_world(pts, mask, T)), jnp.asarray(mask),
                                       jnp.asarray(T[:3, 3]), 32, 256, 1.0)
    j = jsegmentation.ground_removal(ri.points, ri.valid, ri.ranges, 10, 0.0, 10.0)
    p = segmentation.ground_removal(t(ri.points), t(ri.valid), t(ri.ranges), 10, 0.0, 10.0)
    assert (np.asarray(j.ground) == 1).sum() > 500
    np.testing.assert_array_equal(n(p.ground), np.asarray(j.ground))
    np.testing.assert_array_equal(n(p.eligible), np.asarray(j.eligible))


def _snake(H=24, W=96):
    ranges = np.full((H, W), 20.0, np.float32)
    eligible = np.zeros((H, W), bool)
    for k, r in enumerate(range(2, 20, 3)):
        ranges[r, 4:92] = 5.0
        eligible[r, 4:92] = True
        c = 91 if k % 2 == 0 else 4
        ranges[r : r + 4, c] = 5.0
        eligible[r : r + 4, c] = True
    return ranges, eligible


@pytest.mark.parametrize("case", ["blobs", "seam_ring", "snake", "window", "scene"])
def test_label_components_matches_jax(case):
    window = None
    theta = 0.25
    if case == "blobs":
        ranges, eligible = _blobs(24, 96, 0)
    elif case == "seam_ring":  # a fully connected ring and a seam pair
        ranges, eligible = _blobs(16, 64, 1)
        ranges[8:10, :] = 6.0
    elif case == "snake":
        ranges, eligible = _snake()
    elif case == "window":  # the kantplatz 156..356 box, scaled down
        ranges, eligible = _blobs(64, 64, 2)
        r = np.arange(64)[:, None]
        c = np.arange(64)[None, :]
        window = (r >= 20) & (r <= 44) & (c >= 20) & (c <= 44)
    else:
        pts, mask, T = _scene(32, 512)
        ri = jprojection.project_organized(jnp.asarray(_world(pts, mask, T)), jnp.asarray(mask),
                                           jnp.asarray(T[:3, 3]), 32, 512, 1.0)
        g = jsegmentation.ground_removal(ri.points, ri.valid, ri.ranges, 10, 0.0, 10.0)
        ranges, eligible, theta = np.asarray(ri.ranges), np.asarray(g.eligible), 0.1
    H, W = ranges.shape
    ax, ay = 360.0 / W, 2 * 45.0 / (H - 1)
    jw = None if window is None else jnp.asarray(window)
    j = jsegmentation.label_components(jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay, window=jw)
    p = segmentation.label_components(t(ranges), t(eligible), theta, ax, ay,
                                      window=None if window is None else t(window))
    jl = np.asarray(j.labels)
    assert len(np.unique(jl[jl >= 0])) > 1 or case == "snake"
    np.testing.assert_array_equal(n(p.labels), jl)
    np.testing.assert_array_equal(n(p.edge_up), np.asarray(j.edge_up))
    np.testing.assert_array_equal(n(p.edge_left), np.asarray(j.edge_left))
    if case in ("blobs", "seam_ring"):
        assert jl[3, 0] == jl[3, W - 1] >= 0  # merged across the seam


@pytest.mark.parametrize("case", torch_segment_cases.CASES)
def test_segment_objects_matches_jax(case):
    """The port's plain version (the CPU path) against the JAX package on
    tests/torch_segment_cases.py's cases: the three seeds of random blobs,
    equal sizes, a binding candidate cap, few feasible candidates, the
    seam, a window, isolated pixels and an empty image; ``seg_roots``
    against a numpy count."""
    labels, ranges, pts, res, h, kw = torch_segment_cases.case(case)
    j = jsegmentation.segment_objects(jnp.asarray(labels), jnp.asarray(ranges), jnp.asarray(pts),
                                      jnp.asarray(res), jnp.float32(h), **kw)
    with profiling.device_counts("cpu") as counts:
        p = segmentation.segment_objects(t(labels), t(ranges), t(pts), t(res), torch.tensor(h), **kw)
    for a, b in zip(p[:3], j[:3]):
        np.testing.assert_array_equal(n(a), np.asarray(b))
    np.testing.assert_allclose(n(p[3]), np.asarray(j[3]), atol=1e-6)
    roots = torch_segment_cases.qualifying_roots(labels, kw)
    assert counts.get("seg_roots", 0) == roots
    valid = int(np.asarray(j[1]).sum())
    sizes = np.bincount(labels[labels >= 0], minlength=labels.size)
    if case == "empty":
        assert roots == valid == 0
    elif case in ("cap", "singletons"):
        assert roots > kw["candidates"] and valid >= 1
    elif case == "few_feasible":
        assert 1 <= valid < kw["max_objects"]
    elif case == "window":
        assert valid >= 1 and (labels[:20] < 0).all() and (labels[:, 45:] < 0).all()
    else:
        assert valid >= 2
    if case == "ties":  # the slots cut through a run of equal sizes
        taken = sizes[np.asarray(j[0])[np.asarray(j[1])]]
        assert (sizes == taken[-1]).sum() > (taken == taken[-1]).sum()
    if case == "seam":
        assert labels[6, 0] == labels[6, -1] >= 0 and n(p[2])[6, -1] >= 0


# ---------------------------------------------------------------------------
# boxes
# ---------------------------------------------------------------------------


def test_pca_bboxes_matches_jax():
    rng = np.random.default_rng(0)
    S, N = 6, 4096
    pts = np.zeros((N, 3), np.float32)
    slot = rng.integers(-1, S - 1, N).astype(np.int32)  # slot S-1 stays empty
    for s in range(S - 1):
        m = slot == s
        yaw = rng.uniform(-np.pi, np.pi)
        R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
        loc = np.column_stack([rng.uniform(-2, 2, m.sum()), rng.uniform(-0.6, 0.6, m.sum())])
        pts[m, :2] = loc @ R.T + rng.uniform(-10, 10, 2)
        pts[m, 2] = rng.uniform(0.0, 1.5, m.sum())
    slot[slot == 2] = -1
    slot[:40] = 2  # slot 2 is a thin line: the dim-ratio gate rejects it
    pts[:40] = np.column_stack([np.linspace(0, 30, 40), np.zeros(40), np.zeros(40)])
    valid = np.array([True] * (S - 1) + [False])
    avg = rng.uniform(0, 1, S).astype(np.float32)
    args = (pts.reshape(1, N, 3), slot.reshape(1, N), valid, avg)
    j = jbbox.pca_bboxes(*(jnp.asarray(a) for a in args), max_objects=S, max_dim_ratio=7.0)
    p = bbox.pca_bboxes(*(t(a) for a in args), max_objects=S, max_dim_ratio=7.0)
    np.testing.assert_array_equal(n(p.valid), np.asarray(j.valid))
    assert 2 <= int(np.asarray(j.valid).sum()) < S - 1
    np.testing.assert_allclose(n(p.state), np.asarray(j.state), atol=1e-4)
    for f in ("num_points", "density", "avg_residuum"):
        np.testing.assert_allclose(n(getattr(p, f)), np.asarray(getattr(j, f)), rtol=1e-5)


def _random_boxes(rng, k, spread):
    return np.stack([
        rng.uniform(-spread, spread, k), rng.uniform(-spread, spread, k), rng.uniform(-1, 1, k),
        rng.uniform(-0.8, 0.8, k), rng.uniform(0.3, 2.5, k), rng.uniform(0.3, 2.5, k),
        rng.uniform(0.3, 2.5, k),
    ], axis=-1).astype(np.float32)


def test_obb_iou_matches_jax():
    rng = np.random.default_rng(1)
    b1, b2 = _random_boxes(rng, 64, 1.0), _random_boxes(rng, 64, 1.0)
    b2[:4] = b1[:4]  # identical pairs
    b2[4, 3] = b1[4, 3] + np.pi / 4
    j = np.array([float(jbbox.obb_iou(jnp.asarray(a), jnp.asarray(b))) for a, b in zip(b1, b2)])
    p = n(bbox.obb_iou_pairs(t(b1), t(b2)))
    assert (j > 0).sum() > 30
    np.testing.assert_allclose(p, j, atol=1e-5)
    assert abs(float(bbox.obb_iou(t(b1[0]), t(b1[0]))) - 1.0) < 1e-5


@pytest.mark.parametrize("budget", [480, 16])
def test_obb_iou_matrix_gated_matches_jax(budget):
    rng = np.random.default_rng(2)
    D, T = 24, 20
    dets, trks = _random_boxes(rng, D, 2.0), _random_boxes(rng, T, 2.0)
    dv, tv = rng.uniform(size=D) > 0.2, rng.uniform(size=T) > 0.2
    j = np.asarray(jbbox.obb_iou_matrix_gated(jnp.asarray(dets), jnp.asarray(trks),
                                              jnp.asarray(dv), jnp.asarray(tv), budget=budget))
    p = n(bbox.obb_iou_matrix_gated(t(dets), t(trks), t(dv), t(tv), budget=budget))
    np.testing.assert_array_equal(p > 0, j > 0)
    np.testing.assert_allclose(p, j, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_obb_iou_matrix_matches_jax(seed):
    """The dense (D, T) matrix against the JAX package's vmapped one, 1e-6."""
    rng = np.random.default_rng(seed)
    dets, trks = _random_boxes(rng, 24, 2.0), _random_boxes(rng, 20, 2.0)
    trks[:3] = dets[:3]  # identical pairs
    j = np.asarray(jbbox.obb_iou_matrix(jnp.asarray(dets), jnp.asarray(trks)))
    p = n(bbox.obb_iou_matrix(t(dets), t(trks)))
    assert p.shape == (24, 20) and (j > 0).sum() > 40
    np.testing.assert_allclose(p, j, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gated_iou_matrix_equals_dense(seed):
    """The port's gated matrix equals its dense one on valid pairs and is 0
    elsewhere when the budget does not bind (tests/test_assignment.py's
    check of the JAX pair)."""
    rng = np.random.default_rng(seed)
    D, T = 24, 20
    dets, trks = _random_boxes(rng, D, 8.0), _random_boxes(rng, T, 8.0)
    dv, tv = rng.uniform(size=D) > 0.3, rng.uniform(size=T) > 0.3
    dense = n(bbox.obb_iou_matrix(t(dets), t(trks)))
    gated = n(bbox.obb_iou_matrix_gated(t(dets), t(trks), t(dv), t(tv), budget=D * T))
    valid = dv[:, None] & tv[None, :]
    assert (dense[valid] > 0).any()
    np.testing.assert_allclose(gated[valid], dense[valid], atol=1e-6)
    assert np.all(gated[~valid] == 0.0)


# ---------------------------------------------------------------------------
# detect end to end
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("organized", [True, False], ids=["organized", "spherical"])
def test_detect_matches_jax(organized):
    cfg = golden_cfg(organized)
    pts, mask, T = _scene(32, 512)
    w = _world(pts, mask, T)
    rng = np.random.default_rng(3)
    sel = np.flatnonzero(mask)[::4][:2048]
    reg = np.full((2048, 3), 1.0e6, np.float32)
    reg[: len(sel)] = np.nan_to_num(pts[sel])
    reg_mask = np.zeros(2048, bool)
    reg_mask[: len(sel)] = True
    res = np.where(reg_mask, rng.uniform(0.0, 0.4, 2048), 0.0).astype(np.float32)
    sensor = np.where(mask[:, None], np.nan_to_num(pts), np.nan).astype(np.float32)
    j = jdetection.detect(cfg, jnp.asarray(w), jnp.asarray(mask), jnp.asarray(reg),
                          jnp.asarray(reg_mask), jnp.asarray(res), jnp.asarray(T),
                          seg_points_sensor=jnp.asarray(sensor))
    p = detection.detect(port_cfg(cfg), t(w), t(mask), t(reg), t(reg_mask), t(res), t(T),
                         seg_points_sensor=t(sensor))
    assert int(np.asarray(j.objects.valid).sum()) >= 2
    for f in ("labels", "pixel_slot", "ground", "point_index"):
        np.testing.assert_array_equal(n(getattr(p, f)), np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(n(p.objects.valid), np.asarray(j.objects.valid))
    np.testing.assert_allclose(n(p.range_image), np.asarray(j.range_image), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(p.residual_image), np.asarray(j.residual_image), atol=1e-5)
    np.testing.assert_allclose(n(p.objects.num_points), np.asarray(j.objects.num_points))
    np.testing.assert_allclose(n(p.objects.avg_residuum), np.asarray(j.objects.avg_residuum), atol=1e-6)
    assert_boxes_match(n(p.objects.state), np.asarray(j.objects.state))


def test_detect_kantplatz_window():
    """The kantplatz preset's segmentation window (rows/cols 156..356 of a
    512x512 image), at a reduced 32x32 window over a 64x64 image. Its
    camera grid's labels are held to the plain reference
    (``cardbench/reference/components.py``; the port departs from JAX
    there), the objects to JAX's made from those labels, the residual
    image to JAX's."""
    from dynamic_direct_lidar_odometry_tpu import config as jconfig

    cfg = jconfig.kantplatz_config()
    det = dataclasses.replace(cfg.detection, rows=64, columns=64, window_row_min=16,
                              window_row_max=48, window_col_min=16, window_col_max=48)
    cfg = dataclasses.replace(cfg, detection=det)
    T = np.eye(4)
    T[:3, 3] = [0.0, 0.0, 1.2]
    pts, mask, T = _scene(64, 64, T=T)
    w = _world(pts, mask, T)
    reg = np.nan_to_num(pts[::8]).astype(np.float32)
    reg_mask = mask[::8]
    res = np.full(len(reg), 0.2, np.float32)
    j = jdetection.detect(cfg, jnp.asarray(w), jnp.asarray(mask), jnp.asarray(reg),
                          jnp.asarray(reg_mask), jnp.asarray(res), jnp.asarray(T))
    p = detection.detect(port_cfg(cfg), t(w), t(mask), t(reg), t(reg_mask), t(res), t(T))
    pcfg = port_cfg(cfg)
    assert pcfg.detection.residual_grid == "camera"
    ref = camera_reference_labels(pcfg, np.nan_to_num(pts), mask, T)
    assert (ref[:16] == -1).all() and (ref >= 0).any()
    np.testing.assert_array_equal(n(p.labels), ref)
    np.testing.assert_array_equal(n(p.pixel_slot),
                                  jax_objects_from_labels(cfg, w, mask, reg, reg_mask, res, T, ref))
    np.testing.assert_array_equal(n(p.residual_image) > 0, np.asarray(j.residual_image) > 0)

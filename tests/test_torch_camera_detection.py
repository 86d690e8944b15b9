"""The port's segmentation on a depth camera's grid (``residual_grid ==
"camera"``) against the plain reference ``cardbench/reference/
components.py``: the component labels of ``detection.detect`` on seeded
random camera range images (a ground plane and boxes ray-cast on the
camera's equiangular grid, range noise), 32 x 32 and 64 x 64, with the
segmentation window and without. There the port departs from the JAX
package (the camera's pixel angles, no seam; ``detection/detection.py``),
so the reference is the bar. Six workers
run the file in ~14 s on an 8-core Xeon, start-up included."""

import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "cardbench" / "reference"))
import components  # noqa: E402

from dynamic_direct_lidar_odometry_tpu_torch import config  # noqa: E402
from dynamic_direct_lidar_odometry_tpu_torch.detection import detection  # noqa: E402
from dynamic_direct_lidar_odometry_tpu_torch.ops import projection, segmentation  # noqa: E402


def camera_cfg(size: int, windowed: bool):
    """``kantplatz_config()`` at ``size`` x ``size``, its window kept at
    its share of the image (156..356 of 512) or taken away."""
    cfg = config.kantplatz_config()
    det = cfg.detection
    lo, hi = (156 * size // 512, 356 * size // 512) if windowed else (None, None)
    det = dataclasses.replace(det, rows=size, columns=size, window_row_min=lo, window_row_max=hi,
                              window_col_min=lo, window_col_max=hi)
    return dataclasses.replace(cfg, detection=det)


def camera_scene(size: int, seed: int):
    """(H*W, 3) world points, (H*W,) mask and the (4, 4) camera pose: a
    camera 1 m over a ground plane, its optical axis level (pitched up to
    15 deg down), looking at boxes 2-8 m away, 17 mm range noise."""
    rng = np.random.default_rng(seed)
    h = math.radians(projection.CAMERA_HALF_FOV_DEG)
    phi = -h + (np.arange(size) + 0.5) * (2 * h / size)
    th = -h + (np.arange(size) + 0.5) * (2 * h / size)
    ph, tt = np.meshgrid(phi, th, indexing="ij")
    rays = np.stack([np.cos(ph) * np.sin(tt), np.sin(ph), np.cos(ph) * np.cos(tt)], -1).reshape(-1, 3)
    a = math.radians(rng.uniform(0.0, 15.0))
    yaw = rng.uniform(-math.pi, math.pi)
    base = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])  # optical z on base x
    pitch = np.array([[math.cos(a), 0, math.sin(a)], [0, 1, 0], [-math.sin(a), 0, math.cos(a)]])
    yawm = np.array([[math.cos(yaw), -math.sin(yaw), 0], [math.sin(yaw), math.cos(yaw), 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = yawm @ pitch @ base
    T[:3, 3] = [rng.uniform(-1, 1), rng.uniform(-1, 1), 1.0]
    d = rays @ T[:3, :3].T
    o = T[:3, 3]
    t_hit = np.where(d[:, 2] < -1e-9, -o[2] / np.minimum(d[:, 2], -1e-9), np.inf)
    for _ in range(6):
        c = o[:2] + rng.uniform(2.0, 8.0) * np.array([math.cos(yaw + rng.uniform(-1, 1)),
                                                       math.sin(yaw + rng.uniform(-1, 1))])
        half = np.array([*rng.uniform(0.2, 1.5, 2), 0.0])
        lo = np.array([*c, 0.0]) - half
        hi = np.array([*c, rng.uniform(0.5, 3.0)]) + half * [1, 1, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (lo - o) / d, (hi - o) / d
        tmin = np.nanmax(np.minimum(t0, t1), axis=1)
        tmax = np.nanmin(np.maximum(t0, t1), axis=1)
        t_hit = np.where((tmax >= tmin) & (tmin > 1e-6), np.minimum(t_hit, tmin), t_hit)
    mask = np.isfinite(t_hit) & (t_hit < 8.0)
    t_hit = np.where(mask, t_hit * (1.0 + 0.017 * rng.standard_normal(len(t_hit)) / np.maximum(t_hit, 1.0)), 0.0)
    world = np.where(mask[:, None], o + d * t_hit[:, None], 1.0e6).astype(np.float32)
    return world, mask, T.astype(np.float32)


@pytest.mark.parametrize("windowed", [False, True])
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_camera_labels_match_the_plain_reference(size, windowed, seed):
    cfg = camera_cfg(size, windowed)
    assert cfg.detection.residual_grid == "camera"
    world, mask, T = camera_scene(size, seed)
    reg = torch.zeros((8, 3))
    r = detection.detect(cfg, torch.as_tensor(world), torch.as_tensor(mask), reg,
                         torch.zeros(8, dtype=torch.bool), torch.zeros(8), torch.as_tensor(T))
    want = components.labels_for(cfg.detection, world, mask, T[:3, 3])
    got = r.labels.numpy()
    assert (want >= 0).sum() > size  # a scene worth labelling
    assert len(np.unique(want[want >= 0])) < (want >= 0).sum()  # some pixels joined
    assert bool((r.ground == 1).any())  # the ground rule marked some ground
    np.testing.assert_array_equal(got, want)


def test_camera_image_has_no_seam():
    """A row of equal ranges: on a LiDAR ring columns 0 and W-1 join,
    on the camera grid they do not (both with a break in the middle)."""
    H, W = 4, 16
    ranges = torch.full((H, W), 5.0)
    ranges[:, W // 2] = 50.0  # a jump the predicate does not cross
    elig = torch.ones((H, W), dtype=torch.bool)
    ring = segmentation.label_components(ranges, elig, 0.25, 360.0 / W, 2.0, wrap=True).labels
    cam = segmentation.label_components(ranges, elig, 0.25, *projection.camera_pixel_deg(H, W),
                                        wrap=False).labels
    assert int(ring[0, W - 1]) == int(ring[0, 0])
    assert int(cam[0, W - 1]) != int(cam[0, 0])


def test_compare_excuses_only_components_at_a_near_theta_edge():
    """``components.compare`` counts a differing pixel as unexplained
    unless its component touches an edge within one ulp of theta: a label
    moved in a scene with no such edge is unexplained, the reference's own
    labels differ nowhere."""
    cfg = camera_cfg(32, False)
    world, mask, T = camera_scene(32, 0)
    want = components.labels_for(cfg.detection, world, mask, T[:3, 3])
    assert not components.near_theta_edges(cfg.detection, world, mask, T[:3, 3]).any()
    assert components.compare(cfg.detection, want, world, mask, T[:3, 3]) == dict(
        differ=0, near_theta=0, unexplained=0)
    got = want.copy()
    r, c = np.argwhere(want >= 0)[0]
    got[r, c] = -1
    assert components.compare(cfg.detection, got, world, mask, T[:3, 3]) == dict(
        differ=1, near_theta=0, unexplained=1)

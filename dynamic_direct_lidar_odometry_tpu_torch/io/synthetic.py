"""Synthetic structured-LiDAR dataset generator (host-side, NumPy): the
port's own copy of the JAX package's ``io/synthetic.py``, line for line,
so both render bit-identical scans from one seed.

The reference is validated operationally against recorded rosbags
(DOALS ``small_town_simulation``, kantplatz — README.md:26-29); those bags
cannot ship with this repo, so the test/bench oracle is a ray-cast world:
axis-aligned boxes + ground plane rendered into *organized* range scans
(rings x azimuth), exactly the cloud layout the reference expects from an
OS1-class sensor (README.md:14). Moving boxes provide ground-truth dynamic
objects for the detection/tracking stages.

This is deliberately NumPy on host: dataset generation is I/O-side, not
the TPU hot path.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Box:
    center: np.ndarray  # (3,)
    size: np.ndarray  # (3,) full extents
    velocity: Optional[np.ndarray] = None  # (3,) m/s for dynamic boxes

    def at(self, t: float) -> "Box":
        if self.velocity is None:
            return self
        return Box(self.center + t * self.velocity, self.size, self.velocity)


@dataclasses.dataclass
class World:
    boxes: List[Box]
    ground_z: float = 0.0
    max_range: float = 60.0

    @staticmethod
    def town(seed: int = 0, n_static: int = 12, half: float = 25.0) -> "World":
        """A small 'town': ground + walls + random static boxes.

        ``half``: half-extent of the walled square. Smaller towns lower
        the median scan range (the spaciousness metric, odom.cc:970-991)
        and with it the adaptive keyframe distance threshold — the
        steady-state sequences use a dense town so keyframes actually
        accumulate at DOALS thresholds (odom.cc:1156-1178)."""
        rng = np.random.default_rng(seed)
        boxes = [
            # perimeter walls
            Box(np.array([half, 0.0, 2.0]), np.array([0.5, 2 * half, 4.0])),
            Box(np.array([-half, 0.0, 2.0]), np.array([0.5, 2 * half, 4.0])),
            Box(np.array([0.0, half, 2.0]), np.array([2 * half, 0.5, 4.0])),
            Box(np.array([0.0, -half, 2.0]), np.array([2 * half, 0.5, 4.0])),
        ]
        lo = max(half - 5.0, 4.0)
        for _ in range(n_static):
            c = rng.uniform(-lo, lo, 2)
            if np.linalg.norm(c) < 4.0:  # keep spawn area clear
                c = c / np.linalg.norm(c) * 6.0
            sz = rng.uniform(1.0, 5.0, 2)
            h = rng.uniform(1.5, 5.0)
            boxes.append(
                Box(np.array([c[0], c[1], h / 2]), np.array([sz[0], sz[1], h]))
            )
        return World(boxes)


def _ray_aabb(origins, dirs, bmin, bmax):
    """Vectorized slab test. origins/dirs: (N,3). Returns hit t (inf if none)."""
    inv = 1.0 / np.where(np.abs(dirs) < 1e-9, np.copysign(1e-9, dirs), dirs)
    t0 = (bmin - origins) * inv
    t1 = (bmax - origins) * inv
    tmin = np.minimum(t0, t1).max(axis=1)
    tmax = np.maximum(t0, t1).min(axis=1)
    hit = (tmax >= np.maximum(tmin, 1e-6))
    t = np.where(tmin > 1e-6, tmin, tmax)  # allow rays starting inside
    return np.where(hit & (t > 1e-6), t, np.inf)


def render_scan(
    world: World,
    T_ws: np.ndarray,
    H: int = 64,
    W: int = 1024,
    fov_up_deg: float = 16.6,
    fov_down_deg: float = -16.6,
    t: float = 0.0,
    extra_boxes: Sequence[Box] = (),
    noise: float = 0.01,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast one organized scan.

    Args:
      T_ws: (4,4) sensor pose in world frame.
      H, W: rings x azimuth steps. Row 0 = top ring (matches the LeGO-LOAM
        convention the reference's ground removal assumes, detection.cpp:461).
      t: time (moves dynamic boxes).

    Returns:
      (points (H*W, 3) float32 in SENSOR frame, NaN rows for no-return,
       mask (H*W,) bool)
    """
    if rng is None:
        rng = np.random.default_rng(12345)
    elev = np.deg2rad(np.linspace(fov_up_deg, fov_down_deg, H))
    azim = np.linspace(-np.pi, np.pi, W, endpoint=False)
    el, az = np.meshgrid(elev, azim, indexing="ij")
    dirs_s = np.stack(
        [np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)], axis=-1
    ).reshape(-1, 3)

    R, trans = T_ws[:3, :3], T_ws[:3, 3]
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(trans, dirs_w.shape)

    t_hit = np.full(len(dirs_w), np.inf)
    # ground plane
    dz = dirs_w[:, 2]
    t_g = (world.ground_z - trans[2]) / np.where(np.abs(dz) < 1e-9, -1e-9, dz)
    t_hit = np.where(t_g > 1e-6, np.minimum(t_hit, t_g), t_hit)
    # boxes
    for box in list(world.boxes) + list(extra_boxes):
        b = box.at(t)
        bmin = b.center - b.size / 2
        bmax = b.center + b.size / 2
        t_b = _ray_aabb(origins, dirs_w, bmin, bmax)
        t_hit = np.minimum(t_hit, t_b)

    valid = np.isfinite(t_hit) & (t_hit < world.max_range)
    t_fin = np.where(valid, t_hit, 0.0)
    rng_noise = 1.0 + noise * rng.standard_normal(len(t_hit)) / np.maximum(t_fin, 1.0)
    pts_s = dirs_s * (t_fin * rng_noise)[:, None]
    pts_s = np.where(valid[:, None], pts_s, np.nan).astype(np.float32)
    return pts_s, valid


def spiral_trajectory(
    n: int,
    r0: float = 2.5,
    r1: float = 9.0,
    height: float = 1.5,
    turns: float = 0.8,
) -> List[np.ndarray]:
    """Sensor poses along an Archimedean spiral (radius r0 -> r1 over
    ``turns`` revolutions), heading tangent to the path. Positions never
    repeat, so keyframe inserts keep firing over the whole run — the
    steady-state trajectory for benches/accuracy replays (a circle stops
    adding keyframes after one lap)."""
    poses = []
    for i in range(n):
        f = i / max(n - 1, 1)
        a = 2.0 * np.pi * turns * f
        r = r0 + (r1 - r0) * f
        pos = np.array([r * np.cos(a) - r0, r * np.sin(a), height])
        yaw = a + np.pi / 2
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = pos
        poses.append(T)
    return poses


def circular_trajectory(
    n: int, radius: float = 8.0, height: float = 1.5, angle_span: float = np.pi
) -> List[np.ndarray]:
    """Sensor poses along an arc, heading tangent to the path."""
    poses = []
    for i in range(n):
        a = angle_span * i / max(n - 1, 1)
        pos = np.array([radius * np.cos(a) - radius, radius * np.sin(a), height])
        yaw = a + np.pi / 2
        c, s = np.cos(yaw), np.sin(yaw)
        T = np.eye(4)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        T[:3, 3] = pos
        poses.append(T)
    return poses

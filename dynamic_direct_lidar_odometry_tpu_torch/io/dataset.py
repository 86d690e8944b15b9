"""Scan sequences (the port's own copy of the JAX package's ``io/dataset.py``).

A sequence is an organized scan stream:

  points:  (S, H*W, 3) float32, sensor frame, NaN for no-return
  mask:    (S, H*W)   bool
  stamps:  (S,)       float64 seconds

The renderers here are line for line the JAX package's, so one seed gives
bit-identical scans in both (tests/test_torch_config.py checks it by
checksum). Unlike the JAX package, nothing is cached in a file: every
call renders afresh.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np

from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic


@dataclasses.dataclass
class ScanSequence:
    points: np.ndarray  # (S, H*W, 3) float32
    mask: np.ndarray  # (S, H*W) bool
    stamps: np.ndarray  # (S,) float64
    H: int
    W: int
    gt_poses: Optional[np.ndarray] = None  # (S, 4, 4) if known

    def __len__(self) -> int:
        return len(self.points)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, float]]:
        for i in range(len(self)):
            yield self.points[i], self.mask[i], float(self.stamps[i])


def _render(world, poses, H, W, dt, movers, rng) -> ScanSequence:
    pts_all, mask_all = [], []
    for i, T in enumerate(poses):
        pts, mask = synthetic.render_scan(
            world, T, H=H, W=W, t=dt * i, extra_boxes=movers, rng=rng
        )
        pts_all.append(pts)
        mask_all.append(mask)
    return ScanSequence(
        points=np.stack(pts_all),
        mask=np.stack(mask_all),
        stamps=np.arange(len(poses), dtype=np.float64) * dt,
        H=H,
        W=W,
        gt_poses=np.stack(poses),
    )


def synthetic_sequence(
    n_scans: int = 40,
    H: int = 64,
    W: int = 1024,
    n_static: int = 12,
    n_dynamic: int = 2,
    dt: float = 0.1,
    seed: int = 0,
    radius: float = 8.0,
    angle_span: float = np.pi / 2,
) -> ScanSequence:
    """Ray-cast town sequence with ground-truth poses and moving boxes."""
    rng = np.random.default_rng(seed)
    world = synthetic.World.town(seed=seed, n_static=n_static)
    movers: List[synthetic.Box] = []
    for i in range(n_dynamic):
        ang = 2 * np.pi * i / max(n_dynamic, 1)
        pos = np.array([5.0 * np.cos(ang), 5.0 * np.sin(ang), 0.9])
        vel = np.array([-np.sin(ang), np.cos(ang), 0.0]) * 1.5
        movers.append(synthetic.Box(pos, np.array([0.8, 0.8, 1.8]), vel))
    poses = synthetic.circular_trajectory(
        n_scans, radius=radius, angle_span=angle_span
    )
    return _render(world, poses, H, W, dt, movers, rng)


def steady_state_sequence(
    n_scans: int = 64,
    H: int = 64,
    W: int = 2048,
    seed: int = 3,
    dt: float = 0.1,
) -> ScanSequence:
    """The benchmark sequence: a dense walled town replayed along a spiral
    so the keyframe store populates, with two movers that stay >= 5 m
    from the sensor. About a minute of host time for 64 scans."""
    rng = np.random.default_rng(seed)
    world = synthetic.World.town(seed=seed, n_static=16, half=15.0)
    poses = synthetic.spiral_trajectory(n_scans, r0=2.5, r1=9.0, turns=0.8)
    P = np.array([T[:3, 3] for T in poses])

    def path_clear(b, margin=1.5):
        lo = b.center[:2] - b.size[:2] / 2
        hi = b.center[:2] + b.size[:2] / 2
        d = np.maximum(np.maximum(lo - P[:, :2], P[:, :2] - hi), 0.0)
        return float(np.min(np.linalg.norm(d, axis=1))) >= margin

    # keep the walls, drop boxes on the trajectory, add fixed replacements
    # in bands the spiral never visits
    walls, boxes = world.boxes[:4], world.boxes[4:]
    kept = [b for b in boxes if path_clear(b)]
    for cx, cy, sx, sy, h in (
        (5.0, 9.5, 3.0, 2.5, 3.0),
        (10.5, 4.0, 2.5, 3.5, 4.0),
        (12.0, -5.0, 3.0, 2.0, 2.5),
        (4.5, -11.5, 2.5, 2.5, 3.5),
        (-11.5, -11.0, 3.0, 3.0, 3.0),
        (-12.5, 3.0, 2.0, 3.0, 4.5),
    ):
        b = synthetic.Box(np.array([cx, cy, h / 2]), np.array([sx, sy, h]))
        if path_clear(b):
            kept.append(b)
    world.boxes = walls + kept
    movers = [
        synthetic.Box(
            np.array([6.0, -3.0, 0.9]), np.array([0.8, 0.8, 1.8]),
            np.array([0.9, 0.3, 0.0]),
        ),
        synthetic.Box(
            np.array([-10.5, 9.5, 0.9]), np.array([0.8, 0.8, 1.8]),
            np.array([0.5, -0.35, 0.0]),
        ),
    ]
    return _render(world, poses, H, W, dt, movers, rng)

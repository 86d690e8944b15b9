"""Range-image projection (counterpart of ``ops/projection.py``):
``projectScan`` (detection.cpp:254-382) in its organized and spherical
layouts, and ``projectResiduals`` (:203-252) on the LiDAR or camera grid.

Norms are written out as ``sqrt(x*x + y*y + z*z)``, the JAX package's
order of additions, so ranges round the same on both.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class RangeImage(NamedTuple):
    ranges: torch.Tensor  # (H, W) f32, 0 = no return
    points: torch.Tensor  # (H, W, 3) world-frame points (garbage if invalid)
    valid: torch.Tensor  # (H, W) bool
    point_index: torch.Tensor  # (H, W) int32 index into the source cloud


_RAD2DEG = 180.0 / math.pi


def norm3(d: torch.Tensor) -> torch.Tensor:
    """||d|| over the last axis of size 3, as jnp.linalg.norm adds."""
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])


def norm2(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def project_organized(
    points_world: torch.Tensor,
    mask: torch.Tensor,
    sensor_origin: torch.Tensor,
    H: int,
    W: int,
    minimum_range: float,
) -> RangeImage:
    """Organized projection: pixel (r, c) <-> point r*W + c, range =
    ||p - origin|| (detection.cpp:300-329)."""
    pts = points_world.reshape(H, W, 3)
    m = mask.reshape(H, W)
    rng = norm3(pts - sensor_origin)
    valid = m & (rng >= minimum_range)
    rng = torch.where(valid, rng, 0.0)
    idx = torch.arange(H * W, dtype=torch.int32, device=pts.device).reshape(H, W)
    return RangeImage(rng, pts, valid, idx)


def lidar_grid_rowcol(
    points_sensor: torch.Tensor, H: int, W: int, ang_bottom: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row/col on the LeGO-LOAM spherical grid (detection.cpp:344-356),
    ang_res_x = 360/W, ang_res_y = 2*ang_bottom/(H-1). Returns (row, col,
    in_fov)."""
    x, y, z = points_sensor[:, 0], points_sensor[:, 1], points_sensor[:, 2]
    ang_res_x = 360.0 / W
    ang_res_y = 2.0 * ang_bottom / (H - 1)
    v_angle = torch.atan2(z, torch.sqrt(x * x + y * y)) * _RAD2DEG
    row = (H - (v_angle + ang_bottom) / ang_res_y).to(torch.int32)
    in_fov = (row >= 0) & (row < H)
    h_angle = torch.atan2(x, y) * _RAD2DEG
    col = torch.round(h_angle / ang_res_x).to(torch.int32)
    col = torch.where(col >= W, col - W, torch.where(col < 0, col + W, col))
    return row.clamp(0, H - 1), col.clamp(0, W - 1), in_fov


def camera_grid_rowcol(
    points_sensor: torch.Tensor, H: int, W: int, half_fov_deg: float = 60.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row/col on the fork's depth-camera grid (odom.cc:804-827)."""
    x, y, z = points_sensor[:, 0], points_sensor[:, 1], points_sensor[:, 2]
    dev = points_sensor.device
    lim = torch.full((), half_fov_deg, dtype=torch.float32, device=dev) * (math.pi / 180.0)
    theta = torch.atan2(x, z)
    phi = torch.atan2(y, torch.sqrt(x * x + z * z))
    u = ((theta + lim) / (2 * lim) * W).to(torch.int32)
    v = ((phi + lim) / (2 * lim) * H).to(torch.int32)
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    return v.clamp(0, H - 1), u.clamp(0, W - 1), ok


def project_spherical(
    points_world: torch.Tensor,
    mask: torch.Tensor,
    points_sensor: torch.Tensor,
    sensor_origin: torch.Tensor,
    H: int,
    W: int,
    ang_bottom: float,
    minimum_range: float,
) -> RangeImage:
    """Spherical projection of an unorganized cloud (upstream LiDAR mode).

    Several points can land on one pixel. The JAX package scatters with
    ``.at[flat].set``, where on its CPU backend the last point in cloud
    order wins; here the winner is picked deterministically as the
    highest point index per pixel (a scatter-max), then gathered."""
    dev = points_world.device
    n = points_world.shape[0]
    row, col, in_fov = lidar_grid_rowcol(points_sensor, H, W, ang_bottom)
    rng = norm3(points_world - sensor_origin)
    ok = mask & in_fov & (rng >= minimum_range)
    flat = torch.where(ok, row.long() * W + col.long(), H * W)  # H*W: drop slot
    winner = torch.full((H * W + 1,), -1, dtype=torch.long, device=dev)
    winner = winner.scatter_reduce(
        0, flat, torch.arange(n, device=dev), "amax", include_self=True
    )[: H * W]
    hit = winner >= 0
    w = winner.clamp_min(0)
    ranges = torch.where(hit, rng[w], 0.0)
    pts = torch.where(hit[:, None], points_world[w], 0.0)
    valid = ranges > 0
    return RangeImage(
        ranges.reshape(H, W), pts.reshape(H, W, 3), valid.reshape(H, W),
        winner.to(torch.int32).reshape(H, W),
    )


def project_residuals(
    points_sensor: torch.Tensor,
    residuals: torch.Tensor,
    mask: torch.Tensor,
    H: int,
    W: int,
    ang_bottom: float = 45.0,
    grid: str = "lidar",
) -> torch.Tensor:
    """Scatter-max of the registration scan's per-point residuals onto the
    detection grid -> (H, W) residual image (odom.cc:804-827,
    detection.cpp:215-238)."""
    if grid == "camera":
        row, col, ok = camera_grid_rowcol(points_sensor, H, W)
    else:
        row, col, ok = lidar_grid_rowcol(points_sensor, H, W, ang_bottom)
    ok = ok & mask
    flat = torch.where(ok, row.long() * W + col.long(), H * W)
    img = torch.zeros((H * W + 1,), dtype=residuals.dtype, device=residuals.device)
    img = img.scatter_reduce(0, flat, torch.where(ok, residuals, 0.0), "amax", include_self=True)
    return img[: H * W].reshape(H, W)

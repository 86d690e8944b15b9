"""The one traffic generator: a closed loop through a ray-cast town,
rendered on the device from a mix's parameters and the run's seed.

A mix (``cardbench/traffic/<mix>.json``) names the sensor, the town, the
loop and the movers; this module reads any mix and knows none by name.
The renderer is a PyTorch copy of the port's ``io/synthetic.render_scan``
(axis-aligned boxes over a ground plane, organized scans, row 0 the top
row, range noise ``noise / max(t, 1)`` relative), and the town of
``io/synthetic.World.town`` / ``io/dataset.steady_state_sequence``
(walls, static boxes drawn from the mix's layout seed, boxes within the
clearance of the path dropped). Unlike those, the path is a circle and
every mover walks back and forth along a segment a whole number of times
a lap, so a lap cycles with no seam in pose or in movers.

The mix's ``sensor.model`` picks one of two sensor models:

- ``spherical`` (the default): a LiDAR's rows x azimuth scan, elevation
  from ``fov_up_deg`` to ``fov_down_deg`` and azimuth from -pi, in the
  sensor frame (x forward, z up) that the path's poses give.
- ``camera``: a depth camera's rows x columns pixels on the equiangular
  grid of ``half_fov_deg`` on both axes that the port's camera residual
  grid (``ops/projection.camera_grid_rowcol``) inverts, in the optical
  frame (x right, y down, z forward): every return lands back on its own
  pixel. The camera sits on the path's base, optical axis forward,
  pitched down by ``pitch_deg``; the scene's poses are the camera's.

What the seed changes: the scan on the loop that a run starts from and
the sensor noise. The town, the loop and the movers' motion over the lap
come from the mix alone, so every seed gives the same scans in another
order, with other noise: the work per lap does not depend on the seed.

The generator's own ground truth (each scan's pose, the pixels whose
nearest return is a mover, the movers' centres) is the reference's.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_mix(name: str, root: Path = HERE) -> dict:
    """The mix ``name``'s parameters (``<root>/<name>.json``)."""
    path = root / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix file {path}")
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Scene:
    """A town and a loop through it, all in the world frame (metres)."""

    box_lo: np.ndarray  # (K, 3) static boxes' minimum corners (walls first)
    box_hi: np.ndarray  # (K, 3)
    poses: np.ndarray  # (L, 4, 4) the sensor's (a camera's optical) pose at each scan of the lap
    mover_lo: np.ndarray  # (L, M, 3) each mover's box at each scan of the lap
    mover_hi: np.ndarray  # (L, M, 3)
    ground_z: float
    max_range: float


def _town(town: dict) -> List[tuple]:
    """Walls and static boxes as (centre, size) pairs, drawn from the
    layout seed as ``World.town`` draws them, then the mix's fixed boxes
    (``steady_state_sequence``'s bands the path never visits)."""
    rng = np.random.default_rng(int(town["layout_seed"]))
    half, wall_h = float(town["half"]), float(town.get("wall_height", 4.0))
    boxes = [
        (np.array([half, 0.0, wall_h / 2]), np.array([0.5, 2 * half, wall_h])),
        (np.array([-half, 0.0, wall_h / 2]), np.array([0.5, 2 * half, wall_h])),
        (np.array([0.0, half, wall_h / 2]), np.array([2 * half, 0.5, wall_h])),
        (np.array([0.0, -half, wall_h / 2]), np.array([2 * half, 0.5, wall_h])),
    ]
    lo = max(half - 5.0, 4.0)
    for _ in range(int(town["n_static"])):
        c = rng.uniform(-lo, lo, 2)
        if np.linalg.norm(c) < 4.0:
            c = c / np.linalg.norm(c) * 6.0
        sz = rng.uniform(1.0, 5.0, 2)
        h = rng.uniform(1.5, 5.0)
        boxes.append((np.array([c[0], c[1], h / 2]), np.array([sz[0], sz[1], h])))
    for cx, cy, sx, sy, h in town.get("fixed_boxes", []):
        boxes.append((np.array([cx, cy, h / 2]), np.array([sx, sy, h])))
    return boxes


def loop_poses(path: dict) -> np.ndarray:
    """(L, 4, 4) poses on a circle about ``centre``, counter-clockwise,
    heading along the path; scan i at angle ``2 pi i / L``."""
    L, r, h = int(path["scans_per_lap"]), float(path["radius"]), float(path["height"])
    cx, cy = path.get("centre", [0.0, 0.0])
    a = 2.0 * np.pi * np.arange(L) / L
    yaw = a + np.pi / 2
    T = np.tile(np.eye(4), (L, 1, 1))
    T[:, 0, 0], T[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    T[:, 1, 0], T[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    T[:, 0, 3] = cx + r * np.cos(a)
    T[:, 1, 3] = cy + r * np.sin(a)
    T[:, 2, 3] = h
    return T


def footprint_distance(lo: np.ndarray, hi: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """Distance in the ground plane from each point of ``xy`` (P, 2) to a
    box's footprint [lo, hi] (2,)."""
    d = np.maximum(np.maximum(lo - xy, xy - hi), 0.0)
    return np.linalg.norm(d, axis=1)


def mover_centres(movers: dict, t: np.ndarray, lap_s: float) -> np.ndarray:
    """(len(t), M, 3) the movers' centres at times ``t`` (seconds). Mover j
    walks at ``speeds[j]`` back and forth along a segment tangent to its
    ring at angle ``angles_deg[j]`` about the loop's centre, making the
    whole number of round trips a lap that brings its half-span nearest
    ``half_span``: its period divides the lap."""
    size = np.asarray(movers["size"], float)
    out = []
    for ang, ring, v, ph in zip(movers["angles_deg"], movers["rings"], movers["speeds"],
                                movers["phases"]):
        ang = math.radians(ang)
        c0 = np.array([ring * math.cos(ang), ring * math.sin(ang)])
        u = np.array([-math.sin(ang), math.cos(ang)])
        trips = max(1, round(v * lap_s / (4.0 * float(movers["half_span"]))))
        span = v * lap_s / (4.0 * trips)  # out and back once = 4 half-spans
        f = (np.asarray(t, float) * trips / lap_s + ph) % 1.0  # phase in the trip
        tri = np.where(f < 0.5, 4.0 * f - 1.0, 3.0 - 4.0 * f)  # -1 -> 1 -> -1
        xy = c0[None] + tri[:, None] * span * u[None]
        out.append(np.concatenate([xy, np.full((len(xy), 1), size[2] / 2)], axis=1))
    return np.stack(out, axis=1)


def mover_boxes(movers: dict, L: int, dt: float):
    """(L, M, 3) lower and upper corners of the movers at each scan of a
    lap of L scans ``dt`` apart."""
    half = np.asarray(movers["size"], float) / 2
    c = mover_centres(movers, np.arange(L) * dt, L * dt)
    return c - half, c + half


def camera_mount(pitch_deg: float) -> np.ndarray:
    """(4, 4) the optical frame in the base's: optical z (forward) on
    base x, optical x (right) on base -y, optical y (down) on base -z,
    then pitched down by ``pitch_deg`` about the base's y axis."""
    a = math.radians(pitch_deg)
    pitch = np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                      [-math.sin(a), 0.0, math.cos(a)]])
    M = np.eye(4)
    M[:3, :3] = pitch @ np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
    return M


def sensor_model(sensor: dict) -> str:
    """The mix's sensor model: ``spherical`` (the default) or ``camera``."""
    model = sensor.get("model", "spherical")
    if model not in ("spherical", "camera"):
        raise ValueError(f"unknown sensor model {model!r}")
    return model


def build_scene(mix: dict) -> Scene:
    """The mix's town, loop and movers (no randomness but the layout
    seed). For a camera the poses are the optical frame's on the base."""
    town, path, sensor = mix["town"], mix["path"], mix["sensor"]
    base = loop_poses(path)
    xy = base[:, :2, 3]
    poses = base
    if sensor_model(sensor) == "camera":
        poses = base @ camera_mount(float(sensor.get("pitch_deg", 0.0)))
    margin = float(town.get("clear_margin", 1.5))
    boxes = _town(town)
    kept = boxes[:4] + [
        b for b in boxes[4:]
        if footprint_distance(b[0][:2] - b[1][:2] / 2, b[0][:2] + b[1][:2] / 2, xy).min() >= margin
    ]
    c = np.stack([b[0] for b in kept])
    s = np.stack([b[1] for b in kept])
    mlo, mhi = mover_boxes(mix["movers"], len(poses), float(mix["dt"]))
    return Scene(c - s / 2, c + s / 2, poses, mlo, mhi,
                 float(town.get("ground_z", 0.0)), float(sensor.get("max_range", 60.0)))


def sensor_rays(sensor: dict, device) -> torch.Tensor:
    """(H*W, 3) float64 unit rays in the sensor frame, row-major, row 0
    the top: the camera's (``camera_rays``) or the spherical scan's,
    azimuth from -pi (``render_scan``'s grid)."""
    if sensor_model(sensor) == "camera":
        return camera_rays(sensor, device)
    H, W = int(sensor["rows"]), int(sensor["columns"])
    elev = torch.deg2rad(torch.linspace(float(sensor["fov_up_deg"]), float(sensor["fov_down_deg"]), H,
                                        dtype=torch.float64, device=device))
    azim = torch.arange(W, dtype=torch.float64, device=device) * (2 * math.pi / W) - math.pi
    el, az = torch.meshgrid(elev, azim, indexing="ij")
    return torch.stack([el.cos() * az.cos(), el.cos() * az.sin(), el.sin()], dim=-1).reshape(-1, 3)


def camera_rays(sensor: dict, device) -> torch.Tensor:
    """(H*W, 3) float64 unit rays in the optical frame on the equiangular
    grid of half-angle h: pixel (v, u) at phi = -h + (v + 1/2) 2h / H
    (down), theta = -h + (u + 1/2) 2h / W (right), the ray
    (cos phi sin theta, sin phi, cos phi cos theta)."""
    H, W = int(sensor["rows"]), int(sensor["columns"])
    h = math.radians(float(sensor["half_fov_deg"]))
    f64 = dict(dtype=torch.float64, device=device)
    phi = -h + (torch.arange(H, **f64) + 0.5) * (2 * h / H)
    theta = -h + (torch.arange(W, **f64) + 0.5) * (2 * h / W)
    ph, th = torch.meshgrid(phi, theta, indexing="ij")
    return torch.stack([ph.cos() * th.sin(), ph.sin(), ph.cos() * th.cos()], dim=-1).reshape(-1, 3)


def _slab(o, d_inv, lo, hi):
    """Entry distance of rays (B, N, 3) into boxes lo/hi (B, 1, 3) or
    (1, 1, 3): inf where missed (``_ray_aabb``: a ray starting inside
    takes its exit)."""
    t0 = (lo - o) * d_inv
    t1 = (hi - o) * d_inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 1e-6)
    t = torch.where(tmin > 1e-6, tmin, tmax)
    return torch.where(hit & (t > 1e-6), t, torch.inf)


@dataclasses.dataclass
class Lap:
    """A rendered lap, on the device it was rendered on."""

    points: torch.Tensor  # (L, H*W, 3) float32, sensor frame, NaN where no return
    mask: torch.Tensor  # (L, H*W) bool
    mover: torch.Tensor  # (L, H*W) int8: the mover the nearest return hit, -1 none
    scene: Scene


def render_lap(mix: dict, seed: int, device, scans=None, batch: int = 8) -> Lap:
    """Render the mix's lap (or the lap indices ``scans``) on ``device``.
    The noise is drawn per scan of the lap from a generator seeded by
    ``seed``, in ``batch`` scans a call."""
    scene = build_scene(mix)
    sensor = mix["sensor"]
    L = len(scene.poses)
    idx = list(range(L)) if scans is None else list(scans)
    rays = sensor_rays(sensor, device)
    N = rays.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    noise = float(sensor.get("noise", 0.01))
    f64 = dict(dtype=torch.float64, device=device)
    box_lo = torch.as_tensor(scene.box_lo, **f64)[:, None, None]
    box_hi = torch.as_tensor(scene.box_hi, **f64)[:, None, None]
    pts_out = torch.empty((len(idx), N, 3), dtype=torch.float32, device=device)
    mask_out = torch.empty((len(idx), N), dtype=torch.bool, device=device)
    mover_out = torch.empty((len(idx), N), dtype=torch.int8, device=device)
    # one draw of the whole lap's noise, so a subset of scans sees the
    # numbers the whole lap would
    lap_noise = torch.randn((L, N), generator=gen, dtype=torch.float32, device=device)
    for s in range(0, len(idx), batch):
        sel = idx[s:s + batch]
        T = torch.as_tensor(scene.poses[sel], **f64)  # (B, 4, 4)
        d = rays[None] @ T[:, :3, :3].transpose(1, 2)  # (B, N, 3) world rays
        o = T[:, None, :3, 3]  # (B, 1, 3)
        dz = d[..., 2]
        t_g = (scene.ground_z - o[..., 2]) / torch.where(dz.abs() < 1e-9, -1e-9, dz)
        t_hit = torch.where(t_g > 1e-6, t_g, torch.inf)
        d_inv = 1.0 / torch.where(d.abs() < 1e-9, torch.copysign(torch.full_like(d, 1e-9), d), d)
        for k in range(box_lo.shape[0]):
            t_hit = torch.minimum(t_hit, _slab(o, d_inv, box_lo[k], box_hi[k]))
        which = torch.full(t_hit.shape, -1, dtype=torch.int8, device=device)
        mlo = torch.as_tensor(scene.mover_lo[sel], **f64)  # (B, M, 3)
        mhi = torch.as_tensor(scene.mover_hi[sel], **f64)
        for m in range(mlo.shape[1]):
            t_m = _slab(o, d_inv, mlo[:, m, None], mhi[:, m, None])
            which = torch.where(t_m < t_hit, m, which)
            t_hit = torch.minimum(t_hit, t_m)
        valid = torch.isfinite(t_hit) & (t_hit < scene.max_range)
        t_fin = torch.where(valid, t_hit, 0.0)
        scale = 1.0 + noise * lap_noise[sel].double() / torch.clamp_min(t_fin, 1.0)
        p = rays[None] * (t_fin * scale)[..., None]
        pts_out[s:s + len(sel)] = torch.where(valid[..., None], p, torch.nan).float()
        mask_out[s:s + len(sel)] = valid
        mover_out[s:s + len(sel)] = torch.where(valid, which, -1)
    return Lap(pts_out, mask_out, mover_out, scene)


def start_offset(seed: int, L: int) -> int:
    """The lap scan a run with ``seed`` starts from."""
    return int(np.random.default_rng(int(seed)).integers(L))

"""The plain reference of the camera grid's segmentation labels: what
``detection.detect`` labels on a depth camera's organized image
(``residual_grid == "camera"``), written from the rules alone. Plain
PyTorch and NumPy; nothing of the program, of JAX or of the JAX package
is imported here.

The rules (``labelComponents``, detection.cpp:544-724, on the camera's
grid; ``groundRemoval``, :448-508):

- a pixel has a return when its point lies at least ``minimum_range``
  from the sensor;
- ground: rows r-1 and r, for r >= 1 among the bottom ``ground_rows``
  rows, are a ground pair when both have a return and the segment
  between their world points lies within ``ground_angle_threshold``
  degrees of ``sensor_mount_angle`` from the horizontal; both pixels of
  a ground pair are ground;
- a pixel is segmented when it has a return, is not ground and lies
  inside the window (rows and columns ``[min, max]``, bounds included);
- two 4-neighbours that are both segmented are joined when ``atan2(d2
  sin a, d1 - d2 cos a) > theta``, d1 >= d2 their ranges and a the
  angle between them: 120 / W degrees across and 120 / H down (the
  camera's +-60 degrees, equiangular). Column 0 and column W-1 are not
  neighbours;
- components are found by a breadth-first search from each segmented
  pixel not yet labelled, in row-major order, its neighbours visited up,
  right, left, down (``labelComponents``' order); a component's label is
  the flat index of the pixel its search started from, its least.

The predicates are computed in float32 in the program's order of
operations. An edge whose angle lies within one float32 ulp of
``theta`` may be decided the other way by another device's ``atan2``:
:func:`compare` excuses a differing pixel only in a component that
touches such an edge.

:func:`labels_for` and :func:`compare` read the rules' numbers off a
detection configuration (any object with the fields ``rows``,
``columns``, ``theta``, ``minimum_range``, ``ground_rows``,
``ground_angle_threshold``, ``sensor_mount_angle`` and
``window_row_min`` .. ``window_col_max``).
"""

from __future__ import annotations

import collections
import math
from typing import Optional, Tuple

import numpy as np
import torch

HALF_FOV_DEG = 60.0  # the fork's camera grid, +-60 degrees on both axes
_RAD2DEG = 180.0 / math.pi
_NEIGHBOURS = ((-1, 0), (0, 1), (0, -1), (1, 0))  # labelComponents' order


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def ranges_of(points_world, valid, origin, minimum_range: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) ranges (0 where no return) and the return mask, from the
    organized world points, their mask and the sensor's origin."""
    p = _f32(points_world)
    d = p - _f32(origin)
    r = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    ok = torch.as_tensor(np.asarray(valid), dtype=torch.bool) & (r >= minimum_range)
    return torch.where(ok, r, 0.0), ok


def ground(points_world, has_return, ground_rows: int, ground_angle_threshold: float,
           sensor_mount_angle: float = 0.0) -> torch.Tensor:
    """(H, W) bool: the pixels of some ground pair."""
    p = _f32(points_world)
    ok = torch.as_tensor(np.asarray(has_return), dtype=torch.bool)
    H = ok.shape[0]
    d = p[:-1] - p[1:]  # row r-1 less row r, for r = 1 .. H-1
    ang = torch.atan2(d[..., 2], torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])) * _RAD2DEG
    band = (torch.arange(1, H) >= H - ground_rows)[:, None]
    pair = band & ok[:-1] & ok[1:] & (torch.abs(ang - sensor_mount_angle) <= ground_angle_threshold)
    g = torch.zeros(ok.shape, dtype=torch.bool)
    g[1:] |= pair
    g[:-1] |= pair
    return g


def _pixel_rad(H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    across = torch.full((), 2.0 * HALF_FOV_DEG / W, dtype=torch.float32) * (math.pi / 180.0)
    down = torch.full((), 2.0 * HALF_FOV_DEG / H, dtype=torch.float32) * (math.pi / 180.0)
    return across, down


def _angles(ranges: torch.Tensor, axis: int, a: torch.Tensor) -> torch.Tensor:
    """The predicate's angle between each pixel and its predecessor along
    ``axis`` ((H-1, W) down, (H, W-1) across)."""
    n = ranges.shape[axis]
    r0, r1 = ranges.narrow(axis, 0, n - 1), ranges.narrow(axis, 1, n - 1)
    d1, d2 = torch.maximum(r0, r1), torch.minimum(r0, r1)
    return torch.atan2(d2 * torch.sin(a), d1 - d2 * torch.cos(a))


def segmented(ranges, has_return, ground_mask, window: Optional[Tuple[int, int, int, int]]) -> torch.Tensor:
    """(H, W) bool: the pixels the search labels."""
    seg = torch.as_tensor(np.asarray(has_return), dtype=torch.bool) & ~ground_mask
    if window is not None:
        r0, r1, c0, c1 = window
        inside = torch.zeros_like(seg)
        inside[r0:r1 + 1, c0:c1 + 1] = True
        seg &= inside
    return seg


def labels(points_world, valid, origin, *, theta: float, minimum_range: float, ground_rows: int,
           ground_angle_threshold: float, sensor_mount_angle: float = 0.0,
           window: Optional[Tuple[int, int, int, int]] = None) -> np.ndarray:
    """(H, W) int32 component labels of the camera image, -1 where not
    segmented. ``points_world`` (H, W, 3) the organized world points,
    ``valid`` (H, W) their mask, ``origin`` (3,) the sensor's position,
    ``window`` (row_min, row_max, col_min, col_max) or None."""
    rng, ok = ranges_of(points_world, valid, origin, minimum_range)
    seg = segmented(rng, ok, ground(points_world, ok, ground_rows, ground_angle_threshold,
                                    sensor_mount_angle), window).numpy()
    H, W = seg.shape
    across, down = _pixel_rad(H, W)
    join_down = (seg[:-1] & seg[1:]) & (_angles(rng, 0, down) > theta).numpy()  # (r, c) - (r+1, c)
    join_across = (seg[:, :-1] & seg[:, 1:]) & (_angles(rng, 1, across) > theta).numpy()  # (r, c) - (r, c+1)

    def joined(r, c, dr, dc):
        if dr:
            return bool(join_down[min(r, r + dr), c])
        return bool(join_across[r, min(c, c + dc)])

    out = np.full((H, W), -1, dtype=np.int32)
    for start in np.flatnonzero(seg.reshape(-1)):
        r, c = divmod(int(start), W)
        if out[r, c] >= 0:
            continue
        out[r, c] = start
        queue = collections.deque([(r, c)])
        while queue:
            r, c = queue.popleft()
            for dr, dc in _NEIGHBOURS:
                rn, cn = r + dr, c + dc
                if 0 <= rn < H and 0 <= cn < W and out[rn, cn] < 0 and seg[rn, cn] and joined(r, c, dr, dc):
                    out[rn, cn] = start
                    queue.append((rn, cn))
    return out


def _rules(det) -> dict:
    window = None if det.window_row_min is None else (
        det.window_row_min, det.window_row_max, det.window_col_min, det.window_col_max)
    return dict(theta=det.theta, minimum_range=det.minimum_range, ground_rows=det.ground_rows,
                ground_angle_threshold=det.ground_angle_threshold,
                sensor_mount_angle=det.sensor_mount_angle, window=window)


def labels_for(det, points_world, valid, origin) -> np.ndarray:
    """:func:`labels` under a detection configuration's rules; the points
    (H*W, 3) or (H, W, 3) in the world frame, ``valid`` their mask,
    ``origin`` the sensor's position."""
    H, W = det.rows, det.columns
    return labels(np.asarray(points_world).reshape(H, W, 3), np.asarray(valid).reshape(H, W),
                  np.asarray(origin), **_rules(det))


def near_theta_edges(det, points_world, valid, origin) -> np.ndarray:
    """(H, W) bool: the pixels at an end of an edge between segmented
    neighbours whose angle lies within one float32 ulp of ``theta``."""
    H, W = det.rows, det.columns
    kw = _rules(det)
    pts = np.asarray(points_world).reshape(H, W, 3)
    rng, ok = ranges_of(pts, np.asarray(valid).reshape(H, W), np.asarray(origin), kw["minimum_range"])
    seg = segmented(rng, ok, ground(pts, ok, kw["ground_rows"], kw["ground_angle_threshold"],
                                    kw["sensor_mount_angle"]), kw["window"])
    across, down = _pixel_rad(H, W)
    th = torch.tensor(kw["theta"], dtype=torch.float32)
    ulp = torch.nextafter(th, torch.tensor(math.inf)) - th
    ends = torch.zeros_like(seg)
    for axis, a in ((0, down), (1, across)):
        n = seg.shape[axis] - 1
        near = seg.narrow(axis, 0, n) & seg.narrow(axis, 1, n) & ((_angles(rng, axis, a) - th).abs() <= ulp)
        ends.narrow(axis, 0, n).logical_or_(near)
        ends.narrow(axis, 1, n).logical_or_(near)
    return ends.numpy()


def compare(det, got, points_world, valid, origin) -> dict:
    """Another program's labels ``got`` (H, W) against :func:`labels_for`:
    ``differ``, the pixels whose label differs; ``near_theta``, the
    pixels at an end of a near-theta edge; ``unexplained``, the differing
    pixels whose component, in neither labelling, holds such a pixel.
    The labels agree when ``unexplained`` is 0."""
    H, W = det.rows, det.columns
    got = np.asarray(got).reshape(H, W)
    want = labels_for(det, points_world, valid, origin)
    diff = got != want
    if not diff.any():
        return dict(differ=0, near_theta=0, unexplained=0)
    ends = near_theta_edges(det, points_world, valid, origin)
    touched_want = np.isin(want, want[ends & (want >= 0)])
    touched_got = np.isin(got, got[ends & (got >= 0)])
    return dict(differ=int(diff.sum()), near_theta=int(ends.sum()),
                unexplained=int((diff & ~touched_want & ~touched_got).sum()))

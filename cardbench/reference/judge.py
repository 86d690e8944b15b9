"""The plain reference: what each output that reaches a user should be,
worked out from the generator's ground truth, and the numbers that
compare the program's outputs with it. Plain NumPy and PyTorch; nothing
of the program, of JAX or of the JAX package is imported here, and
nothing the program made is taken but the outputs it is judged on.

The numbers (each with its limit in ``cardbench/limits/<cell>.json``),
over the judged scans: the window's first lap of the loop, the same scans
whatever the program's speed:

- ``step_mm``, ``step_mrad``: the largest error of a scan's motion (the
  pose of the scan before it to this one's), translation and rotation,
  over every judged scan of every stream. The pose is what preprocess,
  the PLANE covariances, S2S and S2M GICP and the submap produce.
- ``pose_mm``: the largest distance of a judged pose from the true one
  (the drift since the first scan, whose pose the program is given).
- ``dyn_static``: the share of the static returns (valid, not a mover)
  the program marks dynamic (projection, ground removal, CCL, segments,
  boxes and the tracker's classes decide the mask).
- ``dyn_miss``: the share of mover returns the detector can see (inside
  the configuration's window and range) that the program leaves
  unmarked. None when the judged scans hold too few such returns.
- ``track_miss``: the share of (scan, stream, mover) with a mover the
  detector sees by at least ``MIN_MOVER_PIXELS`` returns and no track
  the program classes dynamic within ``TRACK_RADIUS_M`` of its centre.
  None when no mover is seen so.
- ``kf_wrong``: judged scans whose keyframe flag contradicts the
  keyframe rule wherever the rule's answer does not depend on the
  adaptive distance threshold (0.5-10 m): flagged though a keyframe lies
  within 0.5 m and either the heading is within threshR of the nearest
  or two keyframes lie within 0.75 m; unflagged though every keyframe
  lies beyond 10 m, or the heading turned past threshR with at most one
  keyframe within 15 m. The keyframes are the program's own output
  poses at the scans it flagged.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

DYNAMIC = 2  # the tracker's class for a moving object
MIN_VISIBLE_PIXELS = 1000  # dyn_miss needs this many visible mover returns
MIN_MOVER_PIXELS = 50  # a mover this many returns see is one to track
TRACK_RADIUS_M = 1.0  # a dynamic track this near a mover's centre tracks it


def rotation_angle(R: np.ndarray) -> np.ndarray:
    """Angle (rad) of rotation matrices (..., 3, 3), from both the cosine
    and the sine (the skew part), so that a small angle keeps its
    digits."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], axis=-1)
    return np.arctan2(np.linalg.norm(w, axis=-1) / 2.0, c)


def motion_errors(P: np.ndarray, G: np.ndarray):
    """Per step (translation m, rotation rad) error of the motion
    ``P[k-1]^-1 P[k]`` against ``G[k-1]^-1 G[k]``; P, G (n, 4, 4)."""
    dP = np.linalg.inv(P[:-1]) @ P[1:]
    dG = np.linalg.inv(G[:-1]) @ G[1:]
    t = np.linalg.norm(dP[:, :3, 3] - dG[:, :3, 3], axis=1)
    r = rotation_angle(np.swapaxes(dG[:, :3, :3], 1, 2) @ dP[:, :3, :3])
    return t, r


def keyframe_contradictions(P: np.ndarray, flags: np.ndarray, first: int,
                            thresh_rot_deg: float, d_min: float = 0.5,
                            d_max: float = 10.0) -> int:
    """Scans from ``first`` on whose flag contradicts the keyframe rule
    where its answer is the same for every threshold in [d_min, d_max];
    P (n, 4, 4) the program's poses of one stream, flags (n,) its flags
    (scan 0, the first keyframe, flagged)."""
    kf_t = [P[k, :3, 3] for k in range(first) if flags[k]]
    kf_R = [P[k, :3, :3] for k in range(first) if flags[k]]
    wrong = 0
    for k in range(first, len(P)):
        d = np.linalg.norm(np.array(kf_t) - P[k, :3, 3], axis=1)
        c = int(np.argmin(d))
        theta = np.degrees(rotation_angle(kf_R[c].T @ P[k, :3, :3]))
        turned = theta > thresh_rot_deg
        not_due = d[c] <= d_min and (not turned or np.sum(d <= 1.5 * d_min) >= 2)
        due = d[c] > d_max or (turned and np.sum(d <= 1.5 * d_max) <= 1)
        wrong += int((flags[k] and not_due) or (not flags[k] and due))
        if flags[k]:
            kf_t.append(P[k, :3, 3])
            kf_R.append(P[k, :3, :3])
    return wrong


def visible_movers(points: torch.Tensor, mover: torch.Tensor, det: dict) -> torch.Tensor:
    """(L, H*W) mover returns the detector can see (``mover`` the mover
    id, -1 none): within [minimum_range, max_distance] and inside the
    detection window."""
    H, W = int(det["rows"]), int(det["columns"])
    r = torch.linalg.vector_norm(torch.nan_to_num(points), dim=-1)
    vis = (mover >= 0) & (r >= float(det["minimum_range"])) & (r <= float(det["max_distance"]))
    win = torch.zeros((H, W), dtype=torch.bool, device=points.device)
    r0, r1 = det.get("window_row_min"), det.get("window_row_max")
    c0, c1 = det.get("window_col_min"), det.get("window_col_max")
    win[(r0 or 0):(H if r1 is None else r1), (c0 or 0):(W if c1 is None else c1)] = True
    return vis & win.reshape(1, -1)


class Judge:
    """Accumulates the judged scans' masks and tracks (on their device)
    and gives the numbers at the end."""

    def __init__(self, valid: torch.Tensor, mover: torch.Tensor, visible: torch.Tensor,
                 mover_xy: np.ndarray):
        self.valid, self.mover, self.visible, self.mover_xy = valid, mover, visible, mover_xy
        z = lambda: torch.zeros((), dtype=torch.int64, device=mover.device)  # noqa: E731
        self.static, self.marked, self.seen, self.missed = z(), z(), z(), z()
        self.movers_seen, self.movers_untracked = 0, 0

    def add(self, lap_idx: Sequence[int], dynamic: torch.Tensor, active: np.ndarray,
            status: np.ndarray, track_xy: np.ndarray) -> None:
        """One judged step: ``dynamic`` (B, H*W) the program's masks,
        ``lap_idx`` (B,) each stream's lap scan, and per stream its
        tracks' ``active``, ``status`` (B, T) and positions (B, T, 2)."""
        idx = torch.as_tensor(np.asarray(lap_idx), device=self.mover.device)
        mover, vis, valid = self.mover[idx], self.visible[idx], self.valid[idx]
        static = valid & (mover < 0)
        self.static += static.sum()
        self.marked += (dynamic & static).sum()
        self.seen += vis.sum()
        self.missed += (vis & ~dynamic).sum()
        M = self.mover_xy.shape[1]
        ids = torch.where(vis, mover.long(), M)
        seen = torch.stack([torch.bincount(i, minlength=M + 1)[:M] for i in ids]).cpu().numpy()
        m_xy = self.mover_xy[np.asarray(lap_idx)]  # (B, M, 2)
        dyn = active & (status == DYNAMIC)
        d = np.linalg.norm(track_xy[:, :, None, :] - m_xy[:, None, :, :], axis=-1)  # (B, T, M)
        tracked = (np.where(dyn[:, :, None], d, np.inf) <= TRACK_RADIUS_M).any(axis=1)  # (B, M)
        want = seen >= MIN_MOVER_PIXELS
        self.movers_seen += int(want.sum())
        self.movers_untracked += int((want & ~tracked).sum())

    def masks(self) -> Dict[str, Optional[float]]:
        static, marked = int(self.static), int(self.marked)
        seen, missed = int(self.seen), int(self.missed)
        return dict(
            dyn_static=marked / static if static else None,
            dyn_miss=missed / seen if seen >= MIN_VISIBLE_PIXELS else None,
            track_miss=(self.movers_untracked / self.movers_seen if self.movers_seen else None),
        )


def pose_numbers(P: np.ndarray, G: np.ndarray, first: int) -> Dict[str, float]:
    """step_mm, step_mrad and pose_mm over steps ``first``.. of each
    stream; P, G (n, B, 4, 4), the step before ``first`` included as its
    predecessor."""
    t, r = [], []
    for b in range(P.shape[1]):
        tb, rb = motion_errors(P[first - 1:, b], G[first - 1:, b])
        t.append(tb.max())
        r.append(rb.max())
    drift = np.linalg.norm(P[first:, :, :3, 3] - G[first:, :, :3, 3], axis=-1).max()
    return dict(step_mm=float(max(t)) * 1e3, step_mrad=float(max(r)) * 1e3,
                pose_mm=float(drift) * 1e3)


def compare(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; a number that is None is not compared."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        out[name] = dict(value=v, limit=limit, ok=v is None or (np.isfinite(v) and v <= limit))
    return out

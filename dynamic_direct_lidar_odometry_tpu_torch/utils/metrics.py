"""Trajectory metrics, numpy only (no jax)."""

from __future__ import annotations

from typing import Optional

import numpy as np


def ate_rmse(
    est_positions: np.ndarray,
    gt_poses: np.ndarray,
    est_stamps: Optional[np.ndarray] = None,
    gt_stamps: Optional[np.ndarray] = None,
) -> float:
    """Absolute trajectory error (RMSE), the exact semantics of the JAX
    package's ``runner.ate_rmse``.

    The estimate lives in the frame of the first scan; ground truth is
    world-frame. Without stamps ``est[i]`` pairs with
    ``gt_poses[i + off]``, ``off = len(gt) - len(est)``; with both stamp
    arrays each estimate pairs with the nearest-stamp ground-truth pose.
    The reference frame is the init scan's ground-truth pose.
    """
    est = np.asarray(est_positions)
    if est_stamps is not None and gt_stamps is not None:
        gt_stamps = np.asarray(gt_stamps)
        idx = np.abs(
            gt_stamps[None, :] - np.asarray(est_stamps)[:, None]
        ).argmin(axis=1)
        T0 = gt_poses[max(int(idx.min()) - 1, 0)]
        gt = gt_poses[idx, :3, 3]
    else:
        off = len(gt_poses) - len(est)
        T0 = gt_poses[max(off - 1, 0)]
        gt = gt_poses[off:, :3, 3]
    est_w = est @ T0[:3, :3].T + T0[:3, 3]
    err = est_w - gt
    return float(np.sqrt(np.mean(np.sum(err**2, axis=1))))

"""(The port's copy of the JAX package's ``utils/trajectory.py``; numpy only.)

Trajectory recording: sensor poses (TUM format) + per-object tracks.

Covers two reference artifacts:

- the per-scan TUM pose line the odometry node appends for evo-style ATE
  evaluation ("save traj for evo", odom.cc:143-150,704-709):
  ``timestamp x y z qx qy qz qw``            -> :class:`PoseRecorder`
- the ``trajectories_server`` node (src/util/trajectories_server.cpp):
  per-object-ID polylines built from dynamic bbox streams, saved as
  ``x y z stamp.sec stamp.nsec`` per line (README.md:46,
  trajectories_server.cpp:83-124), with clear/save services
                                             -> :class:`ObjectTrajectories`
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class PoseRecorder:
    """Accumulate per-scan poses; save TUM format for evo ATE."""

    def __init__(self) -> None:
        self.rows: List[np.ndarray] = []

    def append(self, timestamp: float, pose_xyz, quat_wxyz) -> None:
        p = np.asarray(pose_xyz, np.float64).reshape(3)
        q = np.asarray(quat_wxyz, np.float64).reshape(4)
        # TUM order: t x y z qx qy qz qw (odom.cc:704-709 writes the same)
        self.rows.append(
            np.array([timestamp, p[0], p[1], p[2], q[1], q[2], q[3], q[0]])
        )

    def save(self, path: str) -> int:
        arr = np.stack(self.rows) if self.rows else np.zeros((0, 8))
        np.savetxt(path, arr, fmt="%.9f")
        return len(self.rows)

    def positions(self) -> np.ndarray:
        return (
            np.stack(self.rows)[:, 1:4] if self.rows else np.zeros((0, 3))
        )


class ObjectTrajectories:
    """Per-track-ID polylines from the tracker's dynamic bboxes.

    The reference subscribes to ``bboxes_dynamic`` and appends each box's
    BOTTOM-CENTER point (center z - h/2) per label
    (trajectories_server.cpp:28-42 with Trajectory::addPoint
    appending pose.position lowered by dimensions.z/2 upstream in
    tracking.cpp's publishBBoxes)."""

    def __init__(self) -> None:
        self.trajs: Dict[int, List[np.ndarray]] = {}

    def update(self, track_ids, states, valid, timestamp: float) -> None:
        """states: (T, >=7) rows [cx,cy,cz,sin(yaw/2),l,w,h]; valid: (T,)
        bools marking DYNAMIC tracks this frame."""
        ids = np.asarray(track_ids).reshape(-1)
        st = np.asarray(states)
        v = np.asarray(valid).reshape(-1)
        for i in np.nonzero(v)[0]:
            bottom = st[i, :3].astype(np.float64).copy()
            bottom[2] -= float(st[i, 6]) / 2.0
            self.trajs.setdefault(int(ids[i]), []).append(
                np.array([*bottom, timestamp])
            )

    def clear(self) -> None:
        """clear_trajectories service (trajectories_server.cpp:66-81)."""
        self.trajs.clear()

    def save(self, path_prefix: str, min_points: int = 2) -> List[str]:
        """save_trajectories service (trajectories_server.cpp:83-124):
        one ``<prefix>_obj<id>.txt`` per trajectory, lines
        ``x y z stamp.sec stamp.nsec``."""
        written = []
        for oid, pts in sorted(self.trajs.items()):
            if len(pts) < min_points:
                continue
            path = f"{path_prefix}_obj{oid}.txt"
            with open(path, "w") as f:
                for p in pts:
                    sec = int(p[3])
                    nsec = int(round((p[3] - sec) * 1e9))
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {sec} {nsec}\n")
            written.append(path)
        return written

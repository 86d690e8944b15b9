"""Smoke demo of the port: the full DDLO pipeline on a small synthetic
sequence through ``runner.replay`` (counterpart of ``io/demo.py``).

    python -m dynamic_direct_lidar_odometry_tpu_torch.io.demo [n_scans] [device]

Prints per-scan poses and the final ATE against the synthetic ground
truth; runs on the card unless given ``cpu``.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np


def main(n_scans: int = 8, device: str = "cuda") -> int:
    from dynamic_direct_lidar_odometry_tpu_torch import config as cfg_lib
    from dynamic_direct_lidar_odometry_tpu_torch import runner
    from dynamic_direct_lidar_odometry_tpu_torch.io import dataset

    cfg = cfg_lib.doals_config()
    cfg = dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, rows=16, columns=256, ground_rows=4),
        capacity=cfg_lib.CapacityConfig(
            max_points=1024,
            max_submap_points=4096,
            max_keyframes=16,
            max_keyframe_points=1024,
            max_objects=8,
            max_tracks=8,
            nn_chunk=256,
        ),
    )
    # a gentle arc (~1.5 deg/scan), as the JAX demo
    seq = dataset.synthetic_sequence(
        n_scans=n_scans, H=16, W=256, n_dynamic=1,
        angle_span=np.pi / 16 * (n_scans / 8),
    )
    res = runner.replay(cfg, seq, progress=True, device=device)
    ate = runner.ate_rmse(res.poses, seq.gt_poses)
    print(
        f"done: {len(res.poses)} scans, {res.num_keyframes} keyframes, "
        f"{res.map_points} map points, ATE {ate:.3f} m"
    )
    return 0 if ate < 1.0 else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                  sys.argv[2] if len(sys.argv) > 2 else "cuda"))

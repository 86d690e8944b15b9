"""The benchmark scan sequence, rendered in this process (numpy only).

The port's ``io.dataset`` renders afresh on every call (no file cache);
the port's checks hold the scans they use against a committed checksum.
"""

from __future__ import annotations

import hashlib

import numpy as np

from dynamic_direct_lidar_odometry_tpu_torch.io import dataset, synthetic


def steady_state_sequence(n_scans: int = 64) -> dataset.ScanSequence:
    """``dataset.steady_state_sequence(n_scans)``: about a minute of host
    time for 64 scans."""
    return dataset.steady_state_sequence(n_scans)


def sequence_sha256(seq: dataset.ScanSequence, n: int) -> str:
    """Bit-exact checksum of the first ``n`` scans: points (NaN zeroed),
    masks, stamps and ground-truth poses."""
    h = hashlib.sha256()
    for a in (
        np.nan_to_num(np.asarray(seq.points[:n], np.float32)),
        np.asarray(seq.mask[:n], bool),
        np.asarray(seq.stamps[:n], np.float64),
        np.asarray(seq.gt_poses[:n], np.float64),
    ):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def kantplatz_sequence() -> dataset.ScanSequence:
    """Six 512 x 512 organized scans for ``config.kantplatz_config()`` at its
    published size: a dense walled town (seed 11, 20 static boxes, walls
    12 m out) with two movers 10-13 m away, the sensor 1.5 m above the
    ground, moving 0.08 m and turning 0.02 rad per scan. A sparser town
    (tests/test_kantplatz.py's 8 boxes, walls 25 m out) leaves the
    kantplatz preset's 1 cm-epsilon registrations short of the optimum,
    15.7 cm of ATE on the JAX package's CPU run, so two correct
    implementations stop in different places."""
    seed = 11
    world = synthetic.World.town(seed=seed, n_static=20, half=12.0)
    movers = [
        synthetic.Box(np.array([10.8, -5.4, 0.9]), np.array([0.8, 0.8, 1.8]), np.array([0.9, 0.3, 0.0])),
        synthetic.Box(np.array([-9.0, 9.0, 0.9]), np.array([0.8, 0.8, 1.8]), np.array([-0.5, 0.6, 0.0])),
    ]
    poses = []
    for i in range(6):
        th = 0.02 * i
        T = np.eye(4)
        T[:2, :2] = [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
        T[:3, 3] = [0.08 * i, 0.0, 1.5]
        poses.append(T)
    rng = np.random.default_rng(seed)
    return dataset._render(world, poses, 512, 512, 0.1, movers, rng)

"""The benchmark scan sequence, rendered in this process (numpy only).

The port's ``io.dataset`` renders afresh on every call (no file cache);
the port's checks hold the scans they use against a committed checksum.
"""

from __future__ import annotations

import hashlib

import numpy as np

from dynamic_direct_lidar_odometry_tpu_torch.io import dataset


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

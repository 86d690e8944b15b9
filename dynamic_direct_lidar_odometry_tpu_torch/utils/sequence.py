"""The benchmark scan sequence, rendered in this process (numpy only, no jax).

The JAX package's ``io.dataset.steady_state_sequence`` caches its rendering
in a file at a fixed path outside the checkout and trusts whatever it finds
there. The port's checks render the sequence afresh instead, with that cache
switched off, and hold the scans they use against a committed checksum.
"""

from __future__ import annotations

import contextlib
import hashlib

import numpy as np

from dynamic_direct_lidar_odometry_tpu.io import dataset


def _no_file(*args, **kwargs):
    raise OSError("sequence cache disabled")


@contextlib.contextmanager
def _uncached():
    """Within: ``ScanSequence.load`` and ``.save`` raise ``OSError``, which
    ``steady_state_sequence`` takes as a missing, unwritable cache."""
    cls = dataset.ScanSequence
    load, save = cls.__dict__["load"], cls.__dict__["save"]
    cls.load, cls.save = staticmethod(_no_file), _no_file
    try:
        yield
    finally:
        cls.load, cls.save = load, save


def steady_state_sequence(n_scans: int = 64) -> dataset.ScanSequence:
    """``dataset.steady_state_sequence(n_scans)`` rendered afresh: no file
    is read or written (about a minute of host time for 64 scans)."""
    with _uncached():
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

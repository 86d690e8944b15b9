"""``utils.sequence`` renders the benchmark sequence through the port's own
``io.dataset`` with no file cache (``ScanSequence.save`` / ``load`` are
the CLI's dataset files, never a cache), and its checksum pins the scans
bit for bit."""

import copy

import numpy as np

from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
from dynamic_direct_lidar_odometry_tpu_torch.utils import sequence


def test_steady_sequence_reads_and_writes_no_file(monkeypatch):
    touched = []
    monkeypatch.setattr(np, "load", lambda *a, **k: touched.append(("load", a)))
    monkeypatch.setattr(
        np, "savez_compressed", lambda *a, **k: touched.append(("save", a))
    )

    seq = sequence.steady_state_sequence(2)

    assert touched == []
    assert seq.points.shape == (2, 64 * 2048, 3) and seq.mask.shape == (2, 64 * 2048)
    assert seq.gt_poses.shape == (2, 4, 4) and seq.mask.any(axis=1).all()


def _tiny_sequence():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 50, 3)).astype(np.float32)
    pts[:, ::7] = np.nan
    return dataset.ScanSequence(
        points=pts, mask=~np.isnan(pts[..., 0]), stamps=np.arange(3) * 0.1,
        H=5, W=10, gt_poses=np.tile(np.eye(4), (3, 1, 1)),
    )


def test_sequence_sha256_pins_the_prefix_bit_for_bit():
    seq = _tiny_sequence()
    ref = sequence.sequence_sha256(seq, 2)
    assert sequence.sequence_sha256(copy.deepcopy(seq), 2) == ref
    later = copy.deepcopy(seq)
    later.points[2, 0, 0] += 1.0  # outside the first two scans
    assert sequence.sequence_sha256(later, 2) == ref
    ulp = copy.deepcopy(seq)
    ulp.points[1, 1, 2] = np.nextafter(ulp.points[1, 1, 2], np.float32(np.inf))
    assert sequence.sequence_sha256(ulp, 2) != ref
    flipped = copy.deepcopy(seq)
    flipped.mask[0, 1] = not flipped.mask[0, 1]
    assert sequence.sequence_sha256(flipped, 2) != ref
    moved = copy.deepcopy(seq)
    moved.gt_poses[1, 0, 3] = 1e-9
    assert sequence.sequence_sha256(moved, 2) != ref

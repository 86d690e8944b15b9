"""Inputs of ``segmentation.segment_objects``, numpy and the port only (no
JAX): tests/test_torch_detection.py holds the port's plain version to the
JAX package on them, and ``chip_smoke.py`` phase 3 holds the kernel
(``csrc/segment_objects.cu``) to the plain version on them on the card.

:func:`case` returns the arguments as numpy arrays (labels from the
port's ``label_components``, which equals the JAX package's) and the
keywords. The cases: the three seeds of random blobs; components of equal
size (ties go to the lower root); more qualifying roots than candidates
(the cap binds); fewer feasible candidates than slots; a component across
the column seam; a windowed label image (the kantplatz 156..356 box on a
512 x 512 grid, scaled down); isolated pixels, every one a root of size 1
(the candidates' selection among 1,152 equal keys); no labelled pixel.
"""

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch.ops import segmentation

CASES = (0, 1, 2, "ties", "cap", "few_feasible", "seam", "window", "singletons", "empty")

KW = dict(min_line_num=3, valid_point_num=10, valid_line_num=3, max_distance=10.0,
          min_delta_z=0.2, max_delta_z=4.0, max_elevation=3.0, max_objects=6, candidates=16)


def blobs(H, W, seed):
    """Ten random boxes at 3-8 m on a 20 m background, one object across
    the ring seam, 5 % of the pixels ineligible."""
    rng = np.random.default_rng(seed)
    ranges = np.full((H, W), 20.0, np.float32)
    for _ in range(10):
        r0, c0 = rng.integers(0, H - 6), rng.integers(0, W - 10)
        ranges[r0 : r0 + rng.integers(3, 7), c0 : c0 + rng.integers(4, 11)] = rng.uniform(3.0, 8.0)
    ranges[2:6, :5] = 5.0  # one object across the ring seam
    ranges[2:6, -5:] = 5.0
    eligible = rng.uniform(size=(H, W)) > 0.05
    return ranges, eligible


def _boxes(H, W, boxes):
    """Only the boxes (r0, c0, rows, cols, range) are eligible."""
    ranges = np.full((H, W), 20.0, np.float32)
    eligible = np.zeros((H, W), bool)
    for r0, c0, h, w, r in boxes:
        ranges[r0 : r0 + h, c0 : c0 + w] = r
        eligible[r0 : r0 + h, c0 : c0 + w] = True
    return ranges, eligible


def case(name):
    """(labels, ranges, points, residual, sensor_height, kw) of case ``name``."""
    H, W = 24, 96
    kw = dict(KW)
    window = None
    seed = 10 + (name if isinstance(name, int) else CASES.index(name))
    if isinstance(name, int):
        ranges, eligible = blobs(H, W, seed)
    elif name == "ties":  # eight boxes of 24 pixels, two of 30: six slots
        ranges, eligible = _boxes(H, W, [(2 + 7 * (k % 3), 4 + 11 * k, 4, 6, 5.0) for k in range(8)]
                                  + [(3, 90, 5, 6, 6.0), (15, 90, 5, 6, 7.0)])
    elif name == "cap":  # twelve boxes, the four largest out of range: K = 4
        ranges, eligible = _boxes(H, W, [(2 + 6 * (k % 3), 3 + 8 * k, 4, 5 + (k % 4), 12.0 if k < 4 else 5.0)
                                         for k in range(12)])
        kw.update(candidates=4, max_objects=3)
    elif name == "few_feasible":  # three feasible of twelve slots
        ranges, eligible = _boxes(H, W, [(2, 4, 5, 8, 5.0), (10, 30, 6, 7, 6.0), (16, 60, 4, 9, 7.0),
                                         (3, 70, 2, 9, 5.0), (12, 80, 5, 2, 5.0)])
        kw.update(max_objects=12)
    elif name == "seam":  # one box across the seam, spanning 10 rows
        ranges, eligible = _boxes(H, W, [(6, 0, 10, 4, 5.0), (6, W - 4, 10, 4, 5.0), (2, 40, 5, 6, 6.0)])
    elif name == "window":  # the 156..356 box of 512 x 512, scaled to 64 x 64
        H, W = 64, 64
        ranges, eligible = blobs(H, W, seed)
        r, c = np.arange(H)[:, None], np.arange(W)[None, :]
        window = (r >= 20) & (r <= 44) & (c >= 20) & (c <= 44)
        kw.update(max_distance=25.0)  # the background inside the window is an object too
    elif name == "singletons":  # a checkerboard: every eligible pixel is its own root
        ranges = np.full((H, W), 5.0, np.float32)
        eligible = (np.arange(H)[:, None] + np.arange(W)[None, :]) % 2 == 0
        kw.update(valid_point_num=1, valid_line_num=1, min_delta_z=0.0)
    elif name == "empty":
        ranges = np.full((H, W), 5.0, np.float32)
        eligible = np.zeros((H, W), bool)
    else:
        raise ValueError(name)
    rng = np.random.default_rng(name if isinstance(name, int) else seed)
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    labels = segmentation.label_components(
        torch.from_numpy(ranges), torch.from_numpy(eligible), theta, ax, ay,
        window=None if window is None else torch.from_numpy(window)).labels.numpy()
    zz = np.linspace(2.0, 0.0, H)[:, None].repeat(W, 1).astype(np.float32)
    pts = np.stack([ranges, np.zeros_like(ranges), zz], axis=-1)
    res = ((rng.uniform(size=(H, W)) < 0.3) * rng.uniform(0.0, 0.5, (H, W))).astype(np.float32)
    return labels, ranges, pts, res, np.float32(0.0), kw


def qualifying_roots(labels, kw) -> int:
    """Roots of at least the minimum size (the count ``seg_roots``), by numpy."""
    sizes = np.bincount(labels[labels >= 0].ravel(), minlength=1)
    return int((sizes >= max(min(50, kw["valid_point_num"]), 1)).sum())

"""(The port's copy of the JAX package's ``utils/viz.py``; numpy only.)

Debug-image rendering: range / residual / label images.

Equivalent of ``DetectionModule::visualize`` (detection.cpp:834-909),
which publishes three image_transport topics when subscribed:

- range image, normalized to the max range (cv::normalize NORM_MINMAX),
- residual image, normalized,
- label image, random color per component root (detection.cpp:874-890).

Here they render to PNG files (PIL) — the file-drop analogue of an rviz
image view. Pure host-side; PIL is imported only when an image is
written.
"""

from __future__ import annotations

import os

import numpy as np


def _normalize_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float64)
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros(img.shape, np.uint8)
    return ((img - lo) / (hi - lo) * 255.0).astype(np.uint8)


def label_colors(labels: np.ndarray, seed: int = 0) -> np.ndarray:
    """Random color per component root, background black
    (detection.cpp:874-890 uses rand() % 256 per label)."""
    lab = np.asarray(labels)
    out = np.zeros(lab.shape + (3,), np.uint8)
    roots = np.unique(lab[lab >= 0])
    rng = np.random.default_rng(seed)
    colors = rng.integers(40, 256, (len(roots), 3), dtype=np.uint16)
    for root, c in zip(roots, colors):
        out[lab == root] = c.astype(np.uint8)
    return out


def dilate(img: np.ndarray, k: int) -> np.ndarray:
    """k x k max-filter (cv::dilate on the residual debug image,
    detection.cpp:855-856)."""
    if k <= 1:
        return img
    out = np.asarray(img, np.float64).copy()
    h = k // 2
    padded = np.pad(out, h, mode="edge")
    for dr in range(k):
        for dc in range(k):
            out = np.maximum(
                out, padded[dr : dr + out.shape[0], dc : dc + out.shape[1]]
            )
    return out


def save_debug_images(
    out_dir: str,
    idx: int,
    range_image: np.ndarray,
    residual_image: np.ndarray,
    labels: np.ndarray,
    dilate_kernel_size: int = 0,
) -> None:
    """Write range_XXXXXX.png / residual_XXXXXX.png / labels_XXXXXX.png."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    Image.fromarray(_normalize_u8(range_image)).save(
        os.path.join(out_dir, f"range_{idx:06d}.png")
    )
    res = dilate(residual_image, dilate_kernel_size)
    Image.fromarray(_normalize_u8(res)).save(
        os.path.join(out_dir, f"residual_{idx:06d}.png")
    )
    Image.fromarray(label_colors(labels)).save(
        os.path.join(out_dir, f"labels_{idx:06d}.png")
    )

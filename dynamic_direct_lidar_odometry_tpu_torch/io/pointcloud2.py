"""(The port's copy of the JAX package's ``io/pointcloud2.py``; numpy only.)

PointCloud2 byte-buffer decoding, free of any ROS dependency.

The only path between this framework and the reference's real datasets
(the DOALS / kantplatz bags, launch/play_DOALS_data.launch:2-7,
README.md:26-29) is the conversion of ``sensor_msgs/PointCloud2`` byte
buffers into (N, 3) float32 XYZ + validity masks, which the port's
:func:`..io.dataset.convert_rosbag` does here.

Layout reference: a PointCloud2 is ``height*width`` records of
``point_step`` bytes; each field (x/y/z/intensity/...) is a scalar at a
byte ``offset`` inside the record, little-endian unless
``is_bigendian``. x/y/z are NOT guaranteed contiguous or at offset 0
(Ouster clouds pad records to 32/48 bytes).

NumPy-only: this module must import on a bare ROS host.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def field_offsets(fields: Iterable, names=("x", "y", "z")) -> Tuple[int, ...]:
    """x/y/z byte offsets from a PointCloud2 ``fields`` list (any objects
    with ``.name``/``.offset``, so both rosbags' and rospy's field types
    work). Raises KeyError if a coordinate field is missing."""
    by_name = {f.name: int(f.offset) for f in fields}
    try:
        return tuple(by_name[n] for n in names)
    except KeyError as e:  # pragma: no cover - message formatting only
        raise KeyError(
            f"PointCloud2 is missing coordinate field {e}; has "
            f"{sorted(by_name)}"
        ) from e


def decode_xyz(
    data: bytes,
    n_points: int,
    point_step: int,
    offsets: Tuple[int, int, int] = (0, 4, 8),
    is_bigendian: bool = False,
) -> np.ndarray:
    """(n_points, 3) float32 XYZ from a PointCloud2 data buffer.

    Handles arbitrary per-field offsets (non-contiguous x/y/z), arbitrary
    ``point_step`` strides, and endianness. No-return points keep
    whatever the sensor wrote (NaN for the reference's sensors); apply
    :func:`valid_mask` to classify them.
    """
    if point_step < 4:
        raise ValueError(f"point_step={point_step} too small for float32")
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size < n_points * point_step:
        raise ValueError(
            f"buffer has {buf.size} bytes; need {n_points}*{point_step}"
        )
    rec = buf[: n_points * point_step].reshape(n_points, point_step)
    dt = np.dtype(">f4" if is_bigendian else "<f4")
    cols = []
    for off in offsets:
        if off + 4 > point_step:
            raise ValueError(
                f"field offset {off} + 4 exceeds point_step {point_step}"
            )
        # a strided byte slice cannot be .view()ed in place; copy the
        # 4-byte column first (this is the bug class the old inline
        # decoders had: .view(np.float32) on a non-contiguous slice
        # raises for every real point_step > 12)
        cols.append(
            np.ascontiguousarray(rec[:, off : off + 4]).view(dt)[:, 0]
        )
    return np.stack(cols, axis=1).astype(np.float32)


def valid_mask(xyz: np.ndarray, max_abs: float = 1.0e6) -> np.ndarray:
    """(N,) bool: finite AND plausibly-ranged rows. The reference's
    sensors mark no-returns as NaN; some emit huge sentinel coordinates
    instead, so both are masked out."""
    return np.isfinite(xyz).all(axis=1) & (np.abs(xyz) < max_abs).all(axis=1)


def decode_scan(
    data: bytes,
    n_points: int,
    point_step: int,
    offsets: Tuple[int, int, int] = (0, 4, 8),
    is_bigendian: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + mask in one call: returns (points, mask) with invalid
    rows forced to NaN — the ScanSequence on-disk convention
    (io/dataset.py docstring)."""
    xyz = decode_xyz(data, n_points, point_step, offsets, is_bigendian)
    m = valid_mask(xyz)
    return np.where(m[:, None], xyz, np.float32(np.nan)), m

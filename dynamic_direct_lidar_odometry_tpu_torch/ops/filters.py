"""Point-cloud preprocessing filters (counterpart of ``ops/filters.py``).

Same fixed-capacity outputs and the same output ORDER as the JAX
package: the voxel filter's single stable Morton sort sets the chunk
boxes of the sparse NN kernel and the Morton-window covariances, so the
order is part of the contract, not an implementation detail.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL


def rowcol_downsample_mask(
    H: int, W: int, row_step: int, col_step: int, device=None
) -> torch.Tensor:
    """Keep-every-(row_step, col_step) mask over an organized H x W cloud."""
    rows = (torch.arange(H, device=device) % row_step) == 0
    cols = (torch.arange(W, device=device) % col_step) == 0
    return (rows[:, None] & cols[None, :]).reshape(-1)


def decimate(points, mask, H: int, W: int, row_step: int, col_step: int):
    """Row/col decimation of an organized cloud: a static strided slice
    when the buffer holds the full H*W image (valid points keep their
    relative order), else a mask. Returns (points, mask)."""
    if (row_step > 1 or col_step > 1) and points.shape[0] == H * W:
        pts = points.reshape(H, W, -1)[::row_step, ::col_step]
        return (
            pts.reshape(-1, points.shape[-1]),
            mask.reshape(H, W)[::row_step, ::col_step].reshape(-1),
        )
    return points, mask & rowcol_downsample_mask(
        H, W, row_step, col_step, device=mask.device
    )


def crop_box_mask(
    points: torch.Tensor, size: float, translation: torch.Tensor | None = None
) -> torch.Tensor:
    """Negative crop box: True for points OUTSIDE [-size, size]^3 (+trans)."""
    p = points if translation is None else points - translation
    return ~torch.all(torch.abs(p) <= size, dim=-1)


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits so consecutive bits are 3 apart (int64 arithmetic:
    torch's uint32 bit ops are thin, and every value fits in 32 bits)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def voxel_downsample(
    points: torch.Tensor, mask: torch.Tensor, res: float, capacity: int, traced: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-grid filter: one centroid per occupied voxel, in the JAX
    package's order (stable sort on a 30-bit Morton key, groups split on
    the exact integer voxel coords, overflow beyond ``capacity`` and
    invalid rows into a dropped scratch group).

    The voxel coordinates are binned as the JAX package's jitted callers
    bin them: ``res`` from the configuration is a compile-time constant
    there, and XLA multiplies by its f32 reciprocal; ``traced=True`` for
    the callers whose ``res`` is a runtime argument of the jitted function
    (the map node's leaf size), which XLA divides by.

    The centroid sums are a sorted-segment reduction
    (``torch.segment_reduce``), deterministic on every device: the group
    ids are non-decreasing in sorted order, so no atomics are needed.

    Returns (points (capacity, 3) with invalid rows at SENTINEL,
    mask (capacity,) bool).
    """
    big = 2**30
    # mask BEFORE the float->int cast: raw scans carry NaN in invalid rows
    safe = torch.where(mask[:, None], points, 0.0)
    r = torch.full((), res, dtype=torch.float32, device=points.device)
    ik = torch.floor(safe / r if traced else safe * (1.0 / r)).to(torch.int32)
    ik = torch.where(mask[:, None], ik, big)

    u = torch.clamp(ik.to(torch.int64) + 512, 0, 1023)
    key = (_spread3(u[:, 0]) << 2) | (_spread3(u[:, 1]) << 1) | _spread3(u[:, 2])
    key = torch.where(mask, key, 0xFFFFFFFF)  # invalid sort last

    order = torch.argsort(key, stable=True)
    iks = ik[order]
    ps = safe[order]
    ms = mask[order]

    prev = torch.cat([iks[:1] - 1, iks[:-1]], dim=0)
    new_group = torch.any(iks != prev, dim=1)
    gid = torch.cumsum(new_group.to(torch.int64), dim=0) - 1
    gid = torch.where((gid < capacity) & ms, gid, capacity)

    # group sizes by an integer scatter-add (exact in any order) and the
    # reduction without its host-side checks of the lengths: no host read
    lengths = torch.zeros(capacity + 1, dtype=torch.int64, device=gid.device)
    lengths.index_add_(0, gid, torch.ones_like(gid))
    sums = torch.segment_reduce(ps, "sum", lengths=lengths, axis=0, unsafe=True)[:capacity]
    cnts = lengths[:capacity].to(points.dtype)

    out_mask = cnts > 0
    out = sums / torch.clamp_min(cnts, 1.0)[:, None]
    out = torch.where(out_mask[:, None], out, SENTINEL)
    return out, out_mask


def compact(
    points: torch.Tensor, mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack valid points to the front of a ``capacity``-sized buffer
    (stable partition: valid points keep their relative order)."""
    n = points.shape[0]
    order = torch.argsort(torch.where(mask, 0, 1), stable=True)
    ps = points[order][:capacity]
    ms = mask[order][:capacity]
    ps = torch.where(ms[:, None], ps, SENTINEL)
    if capacity > n:
        ps = torch.cat([ps, ps.new_full((capacity - n, 3), SENTINEL)])
        ms = torch.cat([ms, ms.new_zeros(capacity - n)])
    return ps, ms

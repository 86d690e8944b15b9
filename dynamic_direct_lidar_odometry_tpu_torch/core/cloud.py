"""Fixed-capacity masked point clouds (counterpart of ``core/cloud.py``).

A cloud is ``(points (N,3), mask (N,))`` at a fixed capacity; invalid
slots carry the far-away :data:`SENTINEL` so distance-based ops ignore
them without branching.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod

# Far-away sentinel for invalid points: keeps NN distances huge without NaNs.
SENTINEL = 1.0e6


class Cloud(NamedTuple):
    points: torch.Tensor  # (N, 3) float32
    mask: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask)

    def sanitized(self) -> "Cloud":
        """Replace invalid slots by the far-away sentinel."""
        return Cloud(torch.where(self.mask[:, None], self.points, SENTINEL), self.mask)


def from_array(
    points, capacity: Optional[int] = None, mask=None, *, device="cuda"
) -> Cloud:
    """Pack an (M, 3) array (optionally masked; by default the finite
    rows) into a capacity-N cloud on ``device``: invalid rows at 0, the
    tail padded with invalid zero rows."""
    dev = device_mod.resolve(device)
    points = torch.as_tensor(points, device=dev)
    m = points.shape[0]
    mask = torch.isfinite(points).all(dim=-1) if mask is None else torch.as_tensor(mask, device=dev)
    points = torch.where(mask[:, None], points, 0.0).to(torch.float32)
    if capacity is None or capacity == m:
        return Cloud(points, mask)
    if m > capacity:
        raise ValueError(f"cloud of {m} points exceeds capacity {capacity}")
    pad = capacity - m
    return Cloud(
        torch.cat([points, points.new_zeros((pad, 3))]),
        torch.cat([mask, mask.new_zeros((pad,))]),
    )


def empty(capacity: int, dtype=torch.float32, *, device="cuda") -> Cloud:
    dev = device_mod.resolve(device)
    return Cloud(
        torch.zeros((capacity, 3), dtype=dtype, device=dev),
        torch.zeros((capacity,), dtype=torch.bool, device=dev),
    )


def pad_rows(x: torch.Tensor, m: int, fill: float) -> torch.Tensor:
    """Pad the leading dim up to a multiple of ``m`` with ``fill``."""
    pad = (-x.shape[0]) % m
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    return x

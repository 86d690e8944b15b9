"""Fixed-capacity masked point clouds (counterpart of ``core/cloud.py``).

A cloud is ``(points (N,3), mask (N,))`` at a fixed capacity; invalid
slots carry the far-away :data:`SENTINEL` so distance-based ops ignore
them without branching.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Far-away sentinel for invalid points: keeps NN distances huge without NaNs.
SENTINEL = 1.0e6


class Cloud(NamedTuple):
    points: torch.Tensor  # (N, 3) float32
    mask: torch.Tensor  # (N,) bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def pad_rows(x: torch.Tensor, m: int, fill: float) -> torch.Tensor:
    """Pad the leading dim up to a multiple of ``m`` with ``fill``."""
    pad = (-x.shape[0]) % m
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    return x

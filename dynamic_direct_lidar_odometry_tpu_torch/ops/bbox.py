"""Detection container of ``ops/bbox.py``; the box operations follow
with the detection slice (ROADMAP.md queue 1 item 10)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Objects(NamedTuple):
    """Fixed-slot detection list (the reference's detected_objects_)."""

    state: torch.Tensor  # (S, 7) [cx, cy, cz, sin(yaw/2), l, w, h]
    num_points: torch.Tensor  # (S,)
    density: torch.Tensor  # (S,)
    avg_residuum: torch.Tensor  # (S,)
    valid: torch.Tensor  # (S,) bool

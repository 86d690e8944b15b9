"""Detection result container of ``detection/detection.py``; ``detect``
follows with the detection slice (ROADMAP.md queue 1 item 10)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects


class DetectionResult(NamedTuple):
    objects: Objects  # fixed-slot detections
    pixel_slot: torch.Tensor  # (H, W) slot per pixel, -1 = background
    ground: torch.Tensor  # (H, W) int8 ground mat
    range_image: torch.Tensor  # (H, W)
    residual_image: torch.Tensor  # (H, W)
    labels: torch.Tensor  # (H, W) raw component roots
    point_index: torch.Tensor  # (H, W) int32 source point per pixel, -1 = none

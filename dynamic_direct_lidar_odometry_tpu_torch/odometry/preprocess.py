"""Scan preprocessing: decimation -> crop box -> voxel grid, plus the
spaciousness metric (counterpart of ``odometry/preprocess.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.ops import filters


class PreprocessedScan(NamedTuple):
    points: torch.Tensor  # (max_points, 3), sensor frame, SENTINEL-padded
    mask: torch.Tensor  # (max_points,)
    spaciousness_median: torch.Tensor  # () median range of kept points


def preprocess(
    cfg: DDLOConfig, raw_points: torch.Tensor, raw_mask: torch.Tensor
) -> PreprocessedScan:
    """Run the registration-scan preprocessing chain.

    Args:
      raw_points: (H*W, 3) organized scan, row-major, invalid rows anything
        (NaN included).
      raw_mask: (H*W,) validity.
    """
    pre = cfg.preprocessing
    H, W = cfg.detection.rows, cfg.detection.columns
    pts, mask = raw_points, raw_mask
    if pre.downsampling.use:
        pts, mask = filters.decimate(
            pts, mask, H, W, pre.downsampling.row, pre.downsampling.col
        )
    if pre.crop_box.use:
        mask = mask & filters.crop_box_mask(pts, pre.crop_box.size)
    if pre.voxel_scan.use:
        pts, mask = filters.voxel_downsample(
            pts, mask, pre.voxel_scan.res, cfg.capacity.max_points
        )
    else:
        pts, mask = filters.compact(pts, mask, cfg.capacity.max_points)
    return PreprocessedScan(pts, mask, masked_median_range(pts, mask))


def masked_median_range(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median point range over valid points: the cnt//2-th order
    statistic (computeSpaciousness, odom.cc:970-991)."""
    d = torch.sqrt(torch.sum(points * points, dim=1))
    d = torch.where(mask, d, torch.inf)
    cnt = mask.sum()
    srt = torch.sort(d).values
    med = srt[torch.clamp(cnt // 2, 0, d.shape[0] - 1)]
    return torch.where(cnt > 0, med, 0.0)


def adaptive_keyframe_thresh(spaciousness: torch.Tensor) -> torch.Tensor:
    """Spaciousness -> keyframe distance threshold (odom.cc:1156-1178)."""
    s = spaciousness
    return torch.where(
        s > 20.0,
        10.0,
        torch.where(s > 10.0, 5.0, torch.where(s > 5.0, 1.0, 0.5)),
    ).to(torch.float32)

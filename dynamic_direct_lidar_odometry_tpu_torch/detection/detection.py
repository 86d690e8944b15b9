"""Dynamic perception: projection -> ground -> segmentation -> objects
(counterpart of ``detection/detection.py``; ``projectScan`` +
``projectResiduals`` + ``applySegmentation``, detection.cpp:179-382,
448-818).

On the camera grid (``residual_grid == "camera"``, the fork's Azure
Kinect image) the connected components depart from the JAX package,
which takes a LiDAR's ring angles on every grid, in what follows from
the grid alone (:func:`pixel_angles`):

- the angle predicate takes the camera's own pixel angles
  (``projection.camera_pixel_deg``: 0.234 deg at 512 x 512) in place of
  the ring's ``360 / W`` and ``2 ang_bottom / (H - 1)`` (0.703 and 0.352
  deg);
- the image's first and last columns are not neighbours (no seam).

Ground removal is the deployment's on every grid (the bottom
``ground_rows`` rows, detection.cpp:448-508).
``cardbench/reference/components.py`` is the plain version of the
camera grid's labels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.ops import bbox as bbox_ops
from dynamic_direct_lidar_odometry_tpu_torch.ops import projection, segmentation
from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


class DetectionResult(NamedTuple):
    objects: Objects  # fixed-slot detections
    pixel_slot: torch.Tensor  # (H, W) slot per pixel, -1 = background
    ground: torch.Tensor  # (H, W) int8 ground mat
    range_image: torch.Tensor  # (H, W)
    residual_image: torch.Tensor  # (H, W)
    labels: torch.Tensor  # (H, W) raw component roots
    point_index: torch.Tensor  # (H, W) int32 source point per pixel, -1 = none


def pixel_angles(det) -> Tuple[float, float, bool]:
    """(across, down, wrap): the angle predicate's angles in degrees
    between neighbouring pixels, and whether columns 0 and W-1 are
    neighbours. A LiDAR's rings: LeGO-LOAM's ``360 / W`` and ``2
    ang_bottom / (H - 1)`` with the seam (the JAX package's, on every
    grid); the camera's grid: its own angles, no seam."""
    if det.residual_grid == "camera":
        return (*projection.camera_pixel_deg(det.rows, det.columns), False)
    return 360.0 / det.columns, 2.0 * det.ang_bottom / (det.rows - 1), True


def _window_mask(cfg: DDLOConfig, device) -> torch.Tensor | None:
    det = cfg.detection
    if det.window_row_min is None:
        return None
    r = torch.arange(det.rows, device=device)[:, None]
    c = torch.arange(det.columns, device=device)[None, :]
    return (
        (r >= det.window_row_min)
        & (r <= det.window_row_max)
        & (c >= det.window_col_min)
        & (c <= det.window_col_max)
    )


def labels_outside_window(cfg: DDLOConfig, labels) -> int:
    """Labelled pixels of an (H, W) label image outside the segmentation
    window (0 without one): the window's check in the port's tests, the
    kantplatz golden and ``chip_smoke.py``."""
    labels = torch.as_tensor(labels)
    inside = _window_mask(cfg, labels.device)
    if inside is None:
        return 0
    return int(((labels >= 0) & ~inside).sum())


def detect(
    cfg: DDLOConfig,
    seg_points_world: torch.Tensor,  # (H*W, 3) organized, world frame
    seg_mask: torch.Tensor,  # (H*W,)
    reg_points_sensor: torch.Tensor,  # (N, 3) registration cloud, sensor frame
    reg_mask: torch.Tensor,  # (N,)
    residuals: torch.Tensor,  # (N,) S2M NN residuals
    T: torch.Tensor,  # (4, 4) current pose
    seg_points_sensor: torch.Tensor | None = None,  # spherical mode
) -> DetectionResult:
    det = cfg.detection
    H, W = det.rows, det.columns
    S = cfg.capacity.max_objects
    dev = seg_points_world.device
    profiling.mark(dev, begin="detection.project")
    if det.organized:
        ri = projection.project_organized(
            seg_points_world, seg_mask, T[:3, 3], H, W, det.minimum_range
        )
    else:
        if seg_points_sensor is None:
            raise ValueError("spherical mode needs seg_points_sensor")
        ri = projection.project_spherical(
            seg_points_world, seg_mask, seg_points_sensor, T[:3, 3],
            H, W, det.ang_bottom, det.minimum_range,
        )
    res_img = projection.project_residuals(
        reg_points_sensor, residuals, reg_mask, H, W,
        ang_bottom=det.ang_bottom, grid=det.residual_grid,
    )
    g = segmentation.ground_removal(
        ri.points, ri.valid, ri.ranges, det.ground_rows,
        det.sensor_mount_angle, det.ground_angle_threshold,
    )
    profiling.mark(dev, "detection.project", "detection.ccl")
    across, down, wrap = pixel_angles(det)
    seg_res = segmentation.label_components(
        ri.ranges, g.eligible, det.theta, across, down, window=_window_mask(cfg, dev), wrap=wrap,
    )
    profiling.mark(dev, "detection.ccl", "detection.objects")
    roots, slot_valid, pixel_slot, avg_res = segmentation.segment_objects(
        seg_res.labels, ri.ranges, ri.points, res_img, T[2, 3],
        det.min_line_num, det.valid_point_num, det.valid_line_num,
        det.max_distance, det.min_delta_z, det.max_delta_z, det.max_elevation,
        S, candidates=cfg.capacity.segment_candidates,
    )
    objects = bbox_ops.pca_bboxes(
        ri.points, pixel_slot, slot_valid, avg_res, S, det.max_dim_ratio
    )
    # objects rejected by the dim-ratio gate keep their pixels unlabeled
    pixel_slot = torch.where(
        objects.valid[pixel_slot.long().clamp(0, S - 1)] & (pixel_slot >= 0),
        pixel_slot,
        -1,
    )
    profiling.mark(dev, end="detection.objects")
    return DetectionResult(
        objects=objects,
        pixel_slot=pixel_slot,
        ground=g.ground,
        range_image=ri.ranges,
        residual_image=res_img,
        labels=seg_res.labels,
        point_index=ri.point_index,
    )

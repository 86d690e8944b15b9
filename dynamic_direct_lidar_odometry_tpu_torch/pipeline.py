"""The DDLO pipeline transition (counterpart of ``pipeline.py``):

    state', outputs = step(cfg, state, scan, timestamp)

Ported so far: the plain-DLO branch (``cfg.dynamic_detection=False``,
the reference's ``dynamicDetection: false``): odometry, then the
keyframe update on the registered scan, with empty detection and
tracker outputs of the JAX package's shapes. The dynamic branch
(detection + tracking) is ROADMAP.md queue 1 items 10-12.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import se3
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.detection.detection import DetectionResult
from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry
from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects
from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker


class DDLOState(NamedTuple):
    odom: odometry.OdomState
    tracks: tracker.TrackerState
    prev_stamp: torch.Tensor  # () f32 seconds


class DDLOOutputs(NamedTuple):
    odom: odometry.OdomOutputs
    detections: DetectionResult
    tracks: tracker.TrackerOutputs
    static_points: torch.Tensor  # (H*W, 3) world frame
    static_mask: torch.Tensor
    dynamic_mask: torch.Tensor  # (H*W,)
    non_static_mask: torch.Tensor  # (H*W,)
    ground_mask: torch.Tensor  # (H*W,)
    keyframe_added: torch.Tensor  # () bool
    new_keyframe_points: torch.Tensor
    new_keyframe_mask: torch.Tensor


def _require_plain(cfg: DDLOConfig):
    if cfg.dynamic_detection:
        raise NotImplementedError(
            "dynamic_detection=True needs the detection and tracking "
            "slices, not ported yet: ROADMAP.md queue 1 items 10-12. Use "
            "dataclasses.replace(cfg, dynamic_detection=False) for plain DLO."
        )


def init_state(
    cfg: DDLOConfig,
    raw_points,
    raw_mask,
    timestamp: float = 0.0,
    T0=None,
    *,
    device,
) -> DDLOState:
    _require_plain(cfg)
    dev = torch.device(device)
    return DDLOState(
        odom=odometry.init_state(cfg, raw_points, raw_mask, T0, device=dev),
        tracks=tracker.empty_state(cfg.capacity.max_tracks, device=dev),
        prev_stamp=torch.tensor(float(timestamp), dtype=torch.float32, device=dev),
    )


def step(
    cfg: DDLOConfig,
    state: DDLOState,
    raw_points,
    raw_mask,
    timestamp,
    hull_masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
    axis_name: str | None = None,
    pt_size: int = 1,
) -> Tuple[DDLOState, DDLOOutputs]:
    """One DDLO transition. ``raw_points`` (H*W, 3) may carry NaN in
    invalid pixels; numpy inputs are moved to the state's device."""
    _require_plain(cfg)
    dev = state.odom.T.device
    raw_points = torch.as_tensor(raw_points, dtype=torch.float32, device=dev)
    raw_mask = torch.as_tensor(raw_mask, dtype=torch.bool, device=dev)
    H, W = cfg.detection.rows, cfg.detection.columns

    odo_state, odo = odometry.step(
        cfg, state.odom, raw_points, raw_mask, hull_masks,
        axis_name=axis_name, pt_size=pt_size,
    )

    # segmentation scan: the raw organized cloud in the world frame
    seg_world = se3.transform_points(odo.T, raw_points)
    seg_world = torch.where(raw_mask[:, None], seg_world, SENTINEL)

    det = _empty_detection(cfg, dev)
    trk_out = tracker.TrackerOutputs(
        clear_map_boxes=state.tracks.bbox_hist,
        clear_map_valid=torch.zeros_like(state.tracks.bbox_hist[..., 0], dtype=torch.bool),
        matched=torch.full((cfg.capacity.max_objects,), -1, dtype=torch.int32, device=dev),
        spawned=torch.zeros((cfg.capacity.max_objects,), dtype=torch.bool, device=dev),
    )
    no_pixels = torch.zeros((H * W,), dtype=torch.bool, device=dev)
    kf_pts, kf_mask = odo.reg_points_world, odo.reg_mask

    odo_state, added = odometry.update_keyframes(cfg, odo_state, kf_pts, kf_mask)

    new_state = DDLOState(
        odom=odo_state,
        tracks=state.tracks,
        prev_stamp=torch.tensor(float(timestamp), dtype=torch.float32, device=dev),
    )
    outputs = DDLOOutputs(
        odom=odo._replace(new_keyframe=added),
        detections=det,
        tracks=trk_out,
        static_points=seg_world,
        static_mask=raw_mask,
        dynamic_mask=no_pixels,
        non_static_mask=no_pixels,
        ground_mask=no_pixels,
        keyframe_added=added,
        new_keyframe_points=kf_pts,
        new_keyframe_mask=kf_mask,
    )
    return new_state, outputs


def _empty_detection(cfg: DDLOConfig, dev) -> DetectionResult:
    H, W = cfg.detection.rows, cfg.detection.columns
    S = cfg.capacity.max_objects

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return DetectionResult(
        objects=Objects(
            state=z(S, 7),
            num_points=z(S),
            density=z(S),
            avg_residuum=z(S),
            valid=z(S, dtype=torch.bool),
        ),
        pixel_slot=torch.full((H, W), -1, dtype=torch.int32, device=dev),
        ground=z(H, W, dtype=torch.int8),
        range_image=z(H, W),
        residual_image=z(H, W),
        labels=torch.full((H, W), -1, dtype=torch.int32, device=dev),
        point_index=torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W),
    )

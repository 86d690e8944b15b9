"""The full DDLO pipeline transition (counterpart of ``pipeline.py``):

    state', outputs = step(cfg, state, scan, timestamp)

Stage order as in the JAX package (odom.cc:614-729):
  preprocess -> S2S -> submap -> S2M -> residuals   (odometry.step)
  -> project + segment + detect objects             (detection.detect)
  -> track, classify static/dynamic                 (tracker.update)
  -> drop UNDEFINED/DYNAMIC points                  (odom.cc:867-892)
  -> re-filter the static cloud                     (odom.cc:901-918)
  -> keyframe update on the dynamic-free cloud      (odom.cc:696-699)

``cfg.dynamic_detection=False`` is plain DLO: the keyframe update takes
the registered scan, and the detection and tracker outputs are empty.

On the card :func:`step` and :func:`step_chunk` run as captured CUDA
graphs (``core/control.Graph``), the port's counterpart of ``jax.jit``:
one graph per static signature (the configuration, the shapes, whether
hull masks are given, the backends chosen by ``DDLO_NN_IMPL`` /
``DDLO_KNN_IMPL``, and K for a chunk), captured at the first call after
one eager warm-up and replayed after it. The loops and branches inside
(the LM loops, the CCL sweeps, the hull rebuild, the keyframe insert and
its eviction) are conditional nodes decided on the device, so a replay
reads nothing back to the host. :func:`step_eager` keeps the
host-driven step; the CPU and the point-parallel step
(``axis_name``: gloo collectives cannot be captured) always run eagerly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import se3, tree
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.detection import detection
from dynamic_direct_lidar_odometry_tpu_torch.detection.detection import DetectionResult
from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry
from dynamic_direct_lidar_odometry_tpu_torch.ops import filters
from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects
from dynamic_direct_lidar_odometry_tpu_torch.tracking import tracker
from dynamic_direct_lidar_odometry_tpu_torch.tracking.tracker import DYNAMIC, UNDEFINED


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


def init_state(
    cfg: DDLOConfig,
    raw_points,
    raw_mask,
    timestamp: float = 0.0,
    T0=None,
    *,
    device="cuda",
) -> DDLOState:
    """The state after the first scan, on ``device`` (the card unless the
    caller asks for the CPU; without a card the default raises)."""
    dev = device_mod.resolve(device)
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
    axis_name: torch.distributed.ProcessGroup | None = None,
    pt_size: int = 1,
) -> Tuple[DDLOState, DDLOOutputs]:
    """One DDLO transition. ``raw_points`` (H*W, 3) may carry NaN in
    invalid pixels; numpy inputs are moved to the state's device. A
    tensor ``timestamp`` stays on the device (a Python or numpy number is
    written into a device scalar).

    On the card the transition is a replay of a captured graph (see the
    module docstring); the returned state and outputs are fresh tensors,
    never the graph's buffers. The CPU and the point-parallel step
    (``axis_name``) run it op by op from the host, as :func:`step_eager`
    does."""
    dev = state.odom.T.device
    raw_points, raw_mask, stamp = _inputs(dev, raw_points, raw_mask, timestamp)
    if dev.type != "cuda" or axis_name is not None:
        return _step(cfg, state, raw_points, raw_mask, stamp, hull_masks, axis_name, pt_size)
    args = (state, raw_points, raw_mask, stamp, hull_masks)
    return _GRAPHS.get("step", cfg, lambda *a: _step(cfg, *a), args)(*args)


def step_eager(cfg: DDLOConfig, state: DDLOState, raw_points, raw_mask, timestamp,
               hull_masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
               axis_name: torch.distributed.ProcessGroup | None = None,
               pt_size: int = 1) -> Tuple[DDLOState, DDLOOutputs]:
    """:func:`step` driven from the host op by op: every loop and branch
    reads its predicate back between turns."""
    dev = state.odom.T.device
    raw_points, raw_mask, stamp = _inputs(dev, raw_points, raw_mask, timestamp)
    return _step(cfg, state, raw_points, raw_mask, stamp, hull_masks, axis_name, pt_size)


def _inputs(dev, raw_points, raw_mask, timestamp):
    raw_points = torch.as_tensor(raw_points, dtype=torch.float32, device=dev)
    raw_mask = torch.as_tensor(raw_mask, dtype=torch.bool, device=dev)
    if isinstance(timestamp, torch.Tensor):
        stamp = timestamp.to(device=dev, dtype=torch.float32).reshape(())
    else:
        stamp = torch.full((), float(timestamp), dtype=torch.float32, device=dev)
    return raw_points, raw_mask, stamp


# captured graphs by static signature (the configuration among it), at
# most MAX_GRAPHS, the least recently used dropped first
MAX_GRAPHS = 4
_GRAPHS = control.GraphCache(MAX_GRAPHS)


def clear_graphs() -> None:
    """Drop every captured graph (and with it its memory pool)."""
    _GRAPHS.clear()


def graph_stats() -> list:
    """Per cached graph: its kind, capture seconds, the memory its capture
    reserved (bytes) and its replays."""
    return _GRAPHS.stats()


def _step(cfg, state, raw_points, raw_mask, stamp, hull_masks=None, axis_name=None, pt_size=1):
    """The transition on device tensors (the body the graph captures)."""
    dev = state.odom.T.device
    H, W = cfg.detection.rows, cfg.detection.columns
    S = cfg.capacity.max_objects

    odo_state, odo = odometry.step(
        cfg, state.odom, raw_points, raw_mask, hull_masks,
        axis_name=axis_name, pt_size=pt_size,
    )

    # segmentation scan: the raw organized cloud in the world frame
    seg_world = se3.transform_points(odo.T, raw_points)
    seg_world = torch.where(raw_mask[:, None], seg_world, SENTINEL)

    if not cfg.dynamic_detection:
        static_pts, static_mask = seg_world, raw_mask
        det = _empty_detection(cfg, dev)
        trk_out = tracker.TrackerOutputs(
            clear_map_boxes=state.tracks.bbox_hist,
            clear_map_valid=torch.zeros_like(state.tracks.bbox_hist[..., 0], dtype=torch.bool),
            matched=torch.full((S,), -1, dtype=torch.int32, device=dev),
            spawned=torch.zeros((S,), dtype=torch.bool, device=dev),
        )
        trk_state = state.tracks
        non_static = dynamic = ground = torch.zeros((H * W,), dtype=torch.bool, device=dev)
        kf_pts, kf_mask = odo.reg_points_world, odo.reg_mask
    else:
        # ---- dynamic perception (applySegmentation, odom.cc:853-919) ----
        # prev_points is THIS scan's preprocessed cloud (sensor frame), the
        # cloud whose residuals came out of S2M
        det = detection.detect(
            cfg, seg_world, raw_mask, odo_state.prev_points, odo_state.prev_mask,
            odo.residuals, odo.T, seg_points_sensor=raw_points,
        )
        dt = torch.clamp_min(stamp - state.prev_stamp, 1e-3)
        trk_state, trk_out = tracker.update(cfg.tracking, state.tracks, det.objects, dt)

        # ---- remove UNDEFINED + DYNAMIC points (odom.cc:867-892) ----
        non_static_slots = tracker.status_detection_mask(trk_state, (UNDEFINED, DYNAMIC), S)
        dynamic_slots = tracker.status_detection_mask(trk_state, (DYNAMIC,), S)
        # per-pixel slots back to source points: the identity for the
        # organized layout, through the projection's point_index otherwise
        ps_img = det.pixel_slot.reshape(-1)
        g_img = (det.ground == 1).reshape(-1)
        n_pts = raw_mask.shape[0]
        if cfg.detection.organized and n_pts == H * W:
            ps, ground = ps_img, g_img
        else:
            pidx = det.point_index.reshape(-1).long()
            dst = torch.where(pidx >= 0, pidx, n_pts)  # n_pts: the dropped row
            ps = torch.full((n_pts + 1,), -1, dtype=torch.int32, device=dev)
            ps[dst] = ps_img
            ground = torch.zeros((n_pts + 1,), dtype=torch.bool, device=dev)
            ground[dst] = g_img
            ps, ground = ps[:n_pts], ground[:n_pts]
        in_obj = ps >= 0
        psc = ps.long().clamp(0, S - 1)
        non_static = in_obj & non_static_slots[psc]
        dynamic = in_obj & dynamic_slots[psc]

        static_mask = raw_mask & ~non_static
        static_pts = torch.where(static_mask[:, None], seg_world, SENTINEL)

        # ---- re-filter static cloud (odom.cc:901-918): the masks here,
        # the voxel pass inside update_keyframes' add branch ----
        pre = cfg.preprocessing
        sp, m = static_pts, static_mask
        if pre.downsampling.use:
            sp, m = filters.decimate(sp, m, H, W, pre.downsampling.row, pre.downsampling.col)
        if pre.crop_box.use:
            m = m & filters.crop_box_mask(sp, pre.crop_box.size, odo.pose)
        kf_pts, kf_mask = sp, m

    # ---- keyframe update on the (dynamic-free) world cloud ----
    odo_state, added = odometry.update_keyframes(
        cfg, odo_state, kf_pts, kf_mask, refilter=bool(cfg.dynamic_detection)
    )

    new_state = DDLOState(odom=odo_state, tracks=trk_state, prev_stamp=stamp)
    outputs = DDLOOutputs(
        odom=odo._replace(new_keyframe=added),
        detections=det,
        tracks=trk_out,
        static_points=static_pts,
        static_mask=static_mask,
        dynamic_mask=dynamic,
        non_static_mask=non_static,
        ground_mask=ground,
        keyframe_added=added,
        new_keyframe_points=kf_pts,
        new_keyframe_mask=kf_mask,
    )
    return new_state, outputs


def step_chunk(
    cfg: DDLOConfig,
    state: DDLOState,
    pts_stack,
    mask_stack,
    ts_stack,
    hull_masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> Tuple[DDLOState, DDLOOutputs]:
    """K sequential :func:`step` calls (the JAX package's ``lax.scan`` of
    them): ``pts_stack`` (K, H*W, 3), ``mask_stack`` (K, H*W),
    ``ts_stack`` (K,). ``hull_masks`` are held for the whole chunk (hull
    membership changes only on a keyframe insert, and a just-inserted
    keyframe is always selected by the knn-nearest rule). Returns the
    final state and every output field stacked over the K scans.

    On the card the K steps are ONE captured graph, replayed once per
    chunk; on the CPU they run op by op from the host. The stamps stay
    on the device."""
    dev = state.odom.T.device
    pts_stack = torch.as_tensor(pts_stack, dtype=torch.float32, device=dev)
    mask_stack = torch.as_tensor(mask_stack, dtype=torch.bool, device=dev)
    ts_stack = torch.as_tensor(ts_stack, dtype=torch.float32, device=dev)
    args = (state, pts_stack, mask_stack, ts_stack, hull_masks)
    if dev.type != "cuda":
        return _chunk(cfg, *args)
    return _GRAPHS.get("chunk", cfg, lambda *a: _chunk(cfg, *a), args)(*args)


def _chunk(cfg, state, pts_stack, mask_stack, ts_stack, hull_masks):
    outs = []
    for k in range(pts_stack.shape[0]):
        state, out = _step(cfg, state, pts_stack[k], mask_stack[k], ts_stack[k], hull_masks)
        outs.append(out)
    return state, tree.stack(outs)


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

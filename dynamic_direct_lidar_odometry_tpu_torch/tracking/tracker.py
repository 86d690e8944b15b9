"""Multi-object tracker: fixed-slot KF bank + optimal assignment
(counterpart of ``tracking/tracker.py``; TrackingModule, tracking.cpp,
and BoundingBoxFilter, bounding_box_filter.cpp).

Each JAX ``.at[...].set(..., mode="drop")`` becomes a write into a buffer
one row longer than the slots (the dropped writes land in the extra row),
then a slice; argsorts are stable, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.config import TrackingConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.ops import bbox as bbox_ops
from dynamic_direct_lidar_odometry_tpu_torch.ops import hungarian, kalman
from dynamic_direct_lidar_odometry_tpu_torch.ops.bbox import Objects
from dynamic_direct_lidar_odometry_tpu_torch.ops.projection import norm3
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

# Object status (include/tracking/object.h:9-26)
UNDEFINED, STATIC, DYNAMIC = 0, 1, 2

_HIST = 5  # rolling static-bbox window (bounding_box_filter.cpp:238-241)


class TrackerState(NamedTuple):
    active: torch.Tensor  # (T,) bool
    x: torch.Tensor  # (T, 10) KF state
    P: torch.Tensor  # (T, 10, 10) KF covariance
    obj_state: torch.Tensor  # (T, 7) last copied detection state
    status: torch.Tensor  # (T,) int32
    hits: torch.Tensor  # (T,)
    sslu: torch.Tensor  # (T,) steps since last update
    filter_id: torch.Tensor  # (T,)
    next_id: torch.Tensor  # ()
    first_xy: torch.Tensor  # (T, 2) spawn position
    num_points: torch.Tensor  # (T,)
    avg_residuum: torch.Tensor  # (T,)
    det_slot: torch.Tensor  # (T,) detection slot matched this frame, -1
    bbox_hist: torch.Tensor  # (T, 5, 7)
    bbox_hist_len: torch.Tensor  # (T,)

    @property
    def capacity(self) -> int:
        return self.active.shape[0]


class TrackerOutputs(NamedTuple):
    clear_map_boxes: torch.Tensor  # (T, 5, 7)
    clear_map_valid: torch.Tensor  # (T, 5) bool
    matched: torch.Tensor  # (D,) track slot per detection, -1
    spawned: torch.Tensor  # (D,) bool new filter created


def empty_state(max_tracks: int, *, device="cuda") -> TrackerState:
    T = max_tracks
    f32, i32 = torch.float32, torch.int32
    device = device_mod.resolve(device)

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TrackerState(
        active=z(T, dtype=torch.bool),
        x=z(T, 10),
        P=kalman.initial_covariance(device).repeat(T, 1, 1),
        obj_state=z(T, 7),
        status=z(T, dtype=i32),
        hits=z(T, dtype=i32),
        sslu=z(T, dtype=i32),
        filter_id=torch.full((T,), -1, dtype=i32, device=device),
        next_id=torch.tensor(0, dtype=i32, device=device),
        first_xy=z(T, 2),
        num_points=z(T),
        avg_residuum=z(T),
        det_slot=torch.full((T,), -1, dtype=i32, device=device),
        bbox_hist=z(T, _HIST, 7),
        bbox_hist_len=z(T, dtype=i32),
    )


def _cost_matrices(dets: Objects, trk_state, trk_np, d_valid, t_valid, iou_pair_budget=256):
    """Cost 0.8 (1 - IoU) + 0.1 (1 - point-count ratio) and centroid
    displacement, (D, T) each (tracking.cpp:96-114)."""
    iou = bbox_ops.obb_iou_matrix_gated(
        dets.state, trk_state, d_valid, t_valid, budget=iou_pair_budget
    )
    np_d = dets.num_points[:, None]
    np_t = trk_np[None, :]
    ratio = torch.minimum(np_d, np_t) / torch.clamp_min(torch.maximum(np_d, np_t), 1.0)
    cost = 0.8 * (1.0 - iou) + 0.1 * (1.0 - ratio)
    disp = norm3(dets.state[:, None, :3] - trk_state[None, :, :3])
    return cost, disp


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def update(
    cfg: TrackingConfig,
    state: TrackerState,
    dets: Objects,
    dt: torch.Tensor,
) -> Tuple[TrackerState, TrackerOutputs]:
    """One tracker tick (TrackingModule::update, tracking.cpp:27-78)."""
    T = state.capacity
    D = dets.valid.shape[0]
    dev = state.x.device
    profiling.count(dev, "tracker_updates")  # on the device: a replay counts
    dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
    ar_T = torch.arange(T, device=dev)
    ar_D = torch.arange(D, device=dev)

    # ---- predict (tracking.cpp:36-41) ----
    x_pred, P_pred = kalman.predict(state.x, state.P, dt)
    x_pred = torch.where(state.active[:, None], x_pred, state.x)
    P_pred = torch.where(state.active[:, None, None], P_pred, state.P)
    sslu = state.sslu + _i32(state.active)
    trk_state7 = x_pred[:, :7]

    # ---- associate (tracking.cpp:80-150) ----
    cost, disp = _cost_matrices(
        dets, trk_state7, state.num_points, dets.valid, state.active,
        iou_pair_budget=cfg.iou_pair_budget,
    )
    col = hungarian.assign(cost, dets.valid, state.active).long()  # (D,)
    gate = cfg.max_obj_velocity * dt
    col_ok = torch.where((col >= 0) & (disp[ar_D, col.clamp(0, T - 1)] <= gate), col, -1)

    # per-track: which detection matched it (-1 none); matched tracks are
    # distinct, the unmatched detections all write the dropped row T
    det_of_track = torch.full((T + 1,), -1, dtype=torch.long, device=dev)
    det_of_track[torch.where(col_ok >= 0, col_ok, T)] = ar_D
    det_of_track = det_of_track[:T]
    is_matched = det_of_track >= 0
    di = det_of_track.clamp(0, D - 1)

    # ---- matched updates (bounding_box_filter.cpp:64-85) ----
    hits = torch.where(is_matched, state.hits + 1, state.hits)
    sslu = torch.where(is_matched, 0, sslu)
    obj_state = torch.where(is_matched[:, None], dets.state[di], state.obj_state)
    num_points = torch.where(is_matched, dets.num_points[di], state.num_points)
    avg_res = torch.where(is_matched, dets.avg_residuum[di], state.avg_residuum)

    # status machine (bounding_box_filter.cpp:169-217), matched tracks only
    diff = obj_state[:, :2] - state.first_xy
    d2 = torch.sum(diff * diff, dim=-1)
    min_res = obj_state[:, 6] * cfg.residuum_height_ratio
    dyn_check = (avg_res >= min_res) & (
        d2 >= cfg.min_dist_from_origin * cfg.min_dist_from_origin
    )
    st = state.status
    undef = st == UNDEFINED
    to_static = undef & (hits > cfg.max_undefined_hits)
    undef_dyn_eligible = undef & ~to_static & (hits >= cfg.min_dynamic_hits)
    static_branch = (st == STATIC) | undef_dyn_eligible
    to_dynamic = static_branch & dyn_check
    new_status = torch.where(to_dynamic, DYNAMIC, torch.where(to_static, STATIC, st))
    new_status = _i32(torch.where(is_matched, new_status, st))
    turned_dynamic = is_matched & to_dynamic & (st != DYNAMIC) & (state.bbox_hist_len > 0)

    # ---- bbox history (bounding_box_filter.cpp:219-243) ----
    push = is_matched & (new_status == STATIC)
    hist_len = state.bbox_hist_len
    shift_out = push & (hist_len >= _HIST)
    hist = torch.where(
        shift_out[:, None, None],
        torch.cat([state.bbox_hist[:, 1:], state.bbox_hist[:, :1]], dim=1),
        state.bbox_hist,
    )
    write_pos = torch.where(shift_out, _HIST - 1, torch.clamp_max(hist_len, _HIST - 1)).long()
    pushed = hist.clone()
    pushed[ar_T, write_pos] = torch.where(push[:, None], obj_state, hist[ar_T, write_pos])
    hist_len = torch.where(push, torch.clamp_max(hist_len + 1, _HIST), hist_len)

    # ---- KF measurement update for matched tracks ----
    x_upd, P_upd = kalman.update(x_pred, P_pred, dets.state[di])
    x_new = torch.where(is_matched[:, None], x_upd, x_pred)
    P_new = torch.where(is_matched[:, None, None], P_upd, P_pred)

    # ---- clear_map emission: turned-dynamic histories, then reset ----
    clear_valid = turned_dynamic[:, None] & (
        torch.arange(_HIST, device=dev)[None, :] < hist_len[:, None]
    )
    clear_boxes = pushed
    hist_len = torch.where(turned_dynamic, 0, hist_len)

    # ---- erase stale (tracking.cpp:67-73) ----
    alive = state.active & (sslu < cfg.max_no_hits)

    # ---- spawn new filters for unmatched detections (tracking.cpp:52-63) --
    det_matched = col_ok >= 0
    unmatched = dets.valid & ~det_matched
    free = ~alive
    want_rank = torch.cumsum(_i32(unmatched), dim=0) - 1
    n_free = free.sum()
    spawn_det = unmatched & (want_rank < n_free)
    slot_order = torch.argsort(_i32(~free), stable=True)  # free slots first
    det_order = torch.argsort(_i32(~spawn_det), stable=True)
    n_spawn = spawn_det.sum()
    take = ar_T < n_spawn
    spawn_src = torch.full((T,), -1, dtype=torch.long, device=dev)
    spawn_src[slot_order] = torch.where(take, det_order[ar_T.clamp(0, D - 1)], -1)
    spawning = spawn_src >= 0
    si = spawn_src.clamp(0, D - 1)

    x0 = torch.cat([dets.state[si], torch.zeros((T, 3), device=dev)], dim=-1)
    ids = torch.where(spawning, state.next_id + torch.cumsum(_i32(spawning), dim=0) - 1, -1)

    def spawn_where(new, old):
        return torch.where(spawning.reshape((T,) + (1,) * (old.dim() - 1)), new, old)

    active = alive | spawning
    x_new = spawn_where(x0, torch.where(alive[:, None], x_new, state.x * 0))
    P_new = spawn_where(kalman.initial_covariance(dev).repeat(T, 1, 1), P_new)
    obj_state = spawn_where(dets.state[si], obj_state)
    new_status = torch.where(spawning, UNDEFINED, torch.where(alive, new_status, 0))
    hits = torch.where(spawning, 1, torch.where(alive, hits, 0))
    sslu = torch.where(spawning, 0, sslu)
    filter_id = torch.where(spawning, ids, torch.where(alive, state.filter_id, -1))
    first_xy = spawn_where(dets.state[si, :2], state.first_xy)
    num_points = spawn_where(dets.num_points[si], num_points)
    avg_res = spawn_where(dets.avg_residuum[si], avg_res)
    det_track = torch.where(spawning, spawn_src, torch.where(alive, det_of_track, -1))
    hist_len = torch.where(spawning, 0, torch.where(alive, hist_len, 0))

    new_state = TrackerState(
        active=active,
        x=x_new,
        P=P_new,
        obj_state=obj_state,
        status=_i32(new_status),
        hits=_i32(hits),
        sslu=_i32(sslu),
        filter_id=_i32(filter_id),
        next_id=_i32(state.next_id + n_spawn),
        first_xy=first_xy,
        num_points=num_points,
        avg_residuum=avg_res,
        det_slot=_i32(det_track),
        bbox_hist=clear_boxes,
        bbox_hist_len=_i32(hist_len),
    )
    outputs = TrackerOutputs(
        clear_map_boxes=clear_boxes,
        clear_map_valid=clear_valid,
        matched=_i32(col_ok),
        spawned=spawn_det,
    )
    return new_state, outputs


def status_detection_mask(
    state: TrackerState, statuses: Tuple[int, ...], num_det_slots: int
) -> torch.Tensor:
    """Which detection slots belong to active tracks of the given statuses
    (TrackingModule::getIndices, tracking.cpp:192-222): (num_det_slots,)
    bool, to combine with the detection pixel-slot image."""
    sel = torch.zeros_like(state.active)
    for s in statuses:
        sel = sel | (state.status == s)
    sel = sel & state.active & (state.det_slot >= 0)
    out = torch.zeros((num_det_slots + 1,), dtype=torch.bool, device=sel.device)
    out.index_fill_(0, torch.where(sel, state.det_slot.long(), num_det_slots), True)
    return out[:num_det_slots]

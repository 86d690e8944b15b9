"""Tracker state and output containers of ``tracking/tracker.py``;
``update`` follows with the tracking slice (ROADMAP.md queue 1 item 11)."""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def empty_state(max_tracks: int, *, device) -> TrackerState:
    T = max_tracks
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    # P0 = diag(1000 x7, 10000 x3) (bounding_box_filter.cpp:28-30)
    P0 = torch.diag(torch.tensor([1000.0] * 7 + [10000.0] * 3, dtype=f32))
    return TrackerState(
        active=z(T, dtype=torch.bool),
        x=z(T, 10),
        P=P0.to(device).repeat(T, 1, 1),
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

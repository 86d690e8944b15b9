"""Global map accumulation and dynamic-object hygiene (counterpart of
``mapping/mapper.py``, the reference's ``ddlo_map_node``, map.cc):

- ``keyframeCB`` (map.cc:101-131): voxel-filter a keyframe cloud and
  append it to the map                          -> :func:`add_keyframe`
- ``dynamicObjectsCB`` (map.cc:133-156): delete the map points inside
  each static-bbox history entry of a track (yawed box, + margin)
                                                -> :func:`remove_boxes`
- ``publishTimerCB`` / ``savePcd`` (map.cc:83-99,158-189): the voxelized
  map                                           -> :func:`snapshot`

The map is a fixed-capacity ring buffer; every function returns a new
``MapState`` and leaves its argument as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.ops import filters

# elements of one (boxes, C) temporary of remove_boxes: 64 MB in f32, so
# 33 boxes a chunk against the default 500,000-point map
_BOX_CHUNK_ELEMS = 1 << 24


class MapState(NamedTuple):
    points: torch.Tensor  # (C, 3) world frame; invalid rows at SENTINEL
    mask: torch.Tensor  # (C,) bool
    write_ptr: torch.Tensor  # () int32 ring cursor
    total_added: torch.Tensor  # () int32 points ever inserted


def empty_map(capacity: int, *, device="cuda") -> MapState:
    """An empty map of ``capacity`` points on ``device`` (the card unless
    the caller asks for the CPU; without a card the default raises)."""
    dev = device_mod.resolve(device)
    return MapState(
        points=torch.full((capacity, 3), SENTINEL, dtype=torch.float32, device=dev),
        mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        write_ptr=torch.tensor(0, dtype=torch.int32, device=dev),
        total_added=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def add_keyframe(
    state: MapState,
    kf_points: torch.Tensor,
    kf_mask: torch.Tensor,
    leaf_size: float,
    use_voxel_filter: bool = True,
    leaf_capacity: int | None = None,
) -> MapState:
    """Voxelize (or compact) one keyframe cloud and append its valid
    points at the ring cursor, overwriting the oldest once full.

    A cloud with more valid points than the capacity wraps onto itself;
    the JAX package's ordered scatter leaves the LAST ``C`` of them, and
    so does this (only those are written, so no index repeats)."""
    if leaf_capacity is None:
        leaf_capacity = kf_points.shape[0]
    if use_voxel_filter:
        pts, msk = filters.voxel_downsample(kf_points, kf_mask, leaf_size, leaf_capacity, traced=True)
    else:
        pts, msk = filters.compact(kf_points, kf_mask, leaf_capacity)

    C = state.points.shape[0]
    pos = torch.cumsum(msk.to(torch.int32), 0) - 1
    n = msk.sum(dtype=torch.int32)
    keep = msk & (pos >= n - C)
    idx = torch.where(keep, (state.write_ptr + pos) % C, C).long()  # C: the dropped row
    points = torch.cat([state.points, state.points.new_zeros((1, 3))])
    mask = torch.cat([state.mask, state.mask.new_zeros((1,))])
    points[idx] = pts
    mask[idx] = True
    return MapState(
        points=points[:C],
        mask=mask[:C],
        write_ptr=((state.write_ptr + n) % C).to(torch.int32),
        total_added=(state.total_added + n).to(torch.int32),
    )


def remove_boxes(
    state: MapState,
    boxes: torch.Tensor,
    boxes_valid: torch.Tensor,
    margin: float = 0.0,
) -> MapState:
    """Delete the map points inside dynamic-object bbox histories
    (dynamicObjectsCB, map.cc:133-156).

    ``boxes``: (..., 7) rows [cx, cy, cz, sin(yaw/2), l, w, h], the
    tracker's layout; ``boxes_valid``: (...,) bool. The valid boxes are
    tested in chunks that bound each (boxes, C) temporary; a point goes
    if ANY box holds it, so the chunking does not change the mask."""
    b = boxes.reshape(-1, 7)[boxes_valid.reshape(-1)]  # host sync: the valid count
    C = state.points.shape[0]
    hit = torch.zeros((C,), dtype=torch.bool, device=state.points.device)
    for bc in torch.split(b, max(1, _BOX_CHUNK_ELEMS // max(C, 1))):
        yaw = 2.0 * torch.arcsin(torch.clamp(bc[:, 3], -1.0, 1.0))
        c, s = torch.cos(-yaw), torch.sin(-yaw)  # rotate points INTO the box frame
        dx = state.points[None, :, 0] - bc[:, 0, None]
        dy = state.points[None, :, 1] - bc[:, 1, None]
        dz = state.points[None, :, 2] - bc[:, 2, None]
        lx = c[:, None] * dx - s[:, None] * dy
        ly = s[:, None] * dx + c[:, None] * dy
        half = bc[:, 4:7] * 0.5 + margin
        inside = (
            (torch.abs(lx) <= half[:, 0, None])
            & (torch.abs(ly) <= half[:, 1, None])
            & (torch.abs(dz) <= half[:, 2, None])
        )
        hit = hit | torch.any(inside, dim=0)
    new_mask = state.mask & ~hit
    return state._replace(
        mask=new_mask,
        points=torch.where(new_mask[:, None], state.points, SENTINEL),
    )


def snapshot(
    state: MapState, leaf_size: float, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Voxel-filtered copy of the map for publishing and saving
    (publishTimerCB map.cc:83-99; savePcd's filter map.cc:165-176)."""
    return filters.voxel_downsample(state.points, state.mask, leaf_size, capacity, traced=True)


def num_points(state: MapState) -> torch.Tensor:
    """Current map size (the ``map_info`` feedback, map.cc:93-98)."""
    return torch.sum(state.mask.to(torch.int32))

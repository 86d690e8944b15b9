"""Ground removal and range-image segmentation (counterpart of
``ops/segmentation.py``): ``groundRemoval`` (detection.cpp:448-508) as a
shifted-row stencil, ``labelComponents`` (:544-724) as iterated run-min
sweeps, and the fused per-segment gates + slot compaction of
``segment_objects`` (:659-699).

Labels equal the JAX package's bit for bit: a label is the smallest flat
pixel index of its component. One sweep takes, for every pixel, the
minimum over its maximal connected row run (columns wrap around the
ring: the runs touching column 0 and column W-1 merge where the seam
edge holds) and then over its maximal connected column run (rows do not
wrap). The JAX package computes these run minima with packed cummax
scans; here each run gets an id (a cumulative count of breaks along the
axis) and one scatter-min + gather per axis does the same. The loop
stops, as in the JAX package, when a sweep changes nothing or after
``max_iters`` sweeps; the stop test reads one flag back to the host per
sweep (:data:`SWEEPS` counts sweeps and those reads).
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.ops.projection import norm2

_BIG = 2**30
_RAD2DEG = 180.0 / math.pi

# label_components sweeps run and host reads made (one per sweep)
SWEEPS: collections.Counter = collections.Counter()


class GroundResult(NamedTuple):
    ground: torch.Tensor  # (H, W) int8: -1 no-info, 0 not ground, 1 ground
    eligible: torch.Tensor  # (H, W) bool: segmentation candidates


def ground_removal(
    points: torch.Tensor,  # (H, W, 3) world frame
    valid: torch.Tensor,  # (H, W)
    ranges: torch.Tensor,  # (H, W)
    ground_rows: int,
    sensor_mount_angle: float,
    ground_angle_threshold: float,
) -> GroundResult:
    """Mark ground pixels in the bottom ``ground_rows`` rows: row r against
    the ring above, angle = atan2(dz, |dxy|); ground if |angle - mount| <=
    threshold, marking both rows (detection.cpp:448-508)."""
    H, W = ranges.shape
    upper = torch.roll(points, 1, dims=0)  # row r-1 at position r
    upper_valid = torch.roll(valid, 1, dims=0)
    diff = upper - points
    angle = torch.atan2(diff[..., 2], norm2(diff[..., :2])) * _RAD2DEG
    pair_ok = valid & upper_valid
    is_ground_pair = pair_ok & (torch.abs(angle - sensor_mount_angle) <= ground_angle_threshold)
    rows = torch.arange(H, device=ranges.device)[:, None]
    in_band = (rows >= H - ground_rows) & (rows >= 1)
    is_ground_pair = is_ground_pair & in_band
    no_info = ~pair_ok & in_band
    ground = is_ground_pair | torch.roll(is_ground_pair, -1, dims=0)  # mark r-1 too
    g = torch.where(ground, 1, torch.where(no_info, -1, 0)).to(torch.int8)
    eligible = (~ground) & (ranges > 0)
    return GroundResult(g, eligible)


class SegmentationResult(NamedTuple):
    labels: torch.Tensor  # (H, W) int32 component root id; -1 = not segmented
    edge_up: torch.Tensor  # (H, W) connectivity to the row above
    edge_left: torch.Tensor  # (H, W) connectivity to the column left (wrapped)


def _sin_cos_deg(deg: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    rad = torch.tensor(deg, dtype=torch.float32, device=device) * (math.pi / 180.0)
    return torch.sin(rad), torch.cos(rad)


def _run_min(L: torch.Tensor, ids: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Minimum of ``L`` over each run id, read back per element."""
    m = torch.full((n_ids,), _BIG, dtype=L.dtype, device=L.device)
    m = m.scatter_reduce(0, ids, L, "amin", include_self=True)
    return m[ids]


def label_components(
    ranges: torch.Tensor,
    eligible: torch.Tensor,
    theta: float,
    ang_res_x_deg: float,
    ang_res_y_deg: float,
    window: torch.Tensor | None = None,
    max_iters: int = 64,
) -> SegmentationResult:
    """Angle-predicate connected components: pixels join when
    atan2(d2 sin a, d1 - d2 cos a) > theta for neighbors at ranges d1 >= d2
    (labelComponents, detection.cpp:544-724). ``window``: optional (H, W)
    bool restricting segmentation (the fork's 156..356 box)."""
    H, W = ranges.shape
    dev = ranges.device
    if window is not None:
        eligible = eligible & window

    def edge(dim, sin_a, cos_a):
        rn = torch.roll(ranges, 1, dims=dim)
        en = torch.roll(eligible, 1, dims=dim)
        d1 = torch.maximum(ranges, rn)
        d2 = torch.minimum(ranges, rn)
        ang = torch.atan2(d2 * sin_a, d1 - d2 * cos_a)
        return eligible & en & (ang > theta)

    e_up = edge(0, *_sin_cos_deg(ang_res_y_deg, dev))
    e_up[0, :] = False  # vertical edges don't wrap (detection.cpp:591)
    e_left = edge(1, *_sin_cos_deg(ang_res_x_deg, dev))  # col 0 <-> W-1 wraps

    # row runs: key = breaks so far along the row; the seam edge merges the
    # run of column W-1 into the run of column 0
    m_row = e_left.clone()
    m_row[:, 0] = False
    kr = torch.cumsum((~m_row).to(torch.int64), dim=1)  # 1..W
    seam = e_left[:, :1] & (kr == kr[:, -1:])
    kr = torch.where(seam, kr[:, :1], kr)
    row_ids = (kr + torch.arange(H, device=dev)[:, None] * (W + 1)).reshape(-1)
    # column runs (e_up[0] is False: every column starts a run at row 0)
    kc = torch.cumsum((~e_up).to(torch.int64), dim=0)  # 1..H
    col_ids = (kc + torch.arange(W, device=dev)[None, :] * (H + 1)).reshape(-1)
    n_row_ids, n_col_ids = H * (W + 1), W * (H + 1)

    L = torch.where(
        eligible.reshape(-1), torch.arange(H * W, dtype=torch.int32, device=dev), _BIG
    )
    it = 0
    while it < max_iters:
        Ln = _run_min(_run_min(L, row_ids, n_row_ids), col_ids, n_col_ids)
        it += 1
        SWEEPS["sweeps"] += 1
        SWEEPS["host_reads"] += 1
        if torch.equal(Ln, L):
            break
        L = Ln
    labels = torch.where(eligible, L.reshape(H, W), -1)
    return SegmentationResult(labels, e_up, e_left)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, ties toward the lower index."""
    vals, pos = torch.sort(x, descending=True, stable=True)
    return vals[:k], pos[:k]


def segment_objects(
    labels: torch.Tensor,  # (H, W) from label_components
    ranges: torch.Tensor,
    points: torch.Tensor,  # (H, W, 3) world frame
    residual_img: torch.Tensor,  # (H, W)
    sensor_height: torch.Tensor,  # () T[2, 3]
    min_line_num: int,
    valid_point_num: int,
    valid_line_num: int,
    max_distance: float,
    min_delta_z: float,
    max_delta_z: float,
    max_elevation: float,
    max_objects: int,
    candidates: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused feasibility gates + slot compaction over candidate roots (the
    JAX package's ``segment_objects``): per-root sizes from one sort; the
    top-``candidates`` roots passing the minimum size; every other
    statistic as a dense (K, H*W) masked reduction over those; the gates
    of detection.cpp:659-699 (including the hardcoded size 50); the
    largest ``max_objects`` feasible roots become slots.

    Returns slot_roots (S,) int32 (-1 = empty), slot_valid (S,),
    pixel_slot (H, W) int32 (-1 = none), slot_avg_residuum (S,)."""
    H, W = labels.shape
    n = H * W
    dev = labels.device
    lab = labels.reshape(-1)
    member = lab >= 0
    seg = torch.where(member, lab, n)

    # per-root pixel counts from the sorted root ids: each root is one run
    srt = torch.sort(seg).values
    idx = torch.arange(n, device=dev)
    true1 = torch.ones((1,), dtype=torch.bool, device=dev)
    is_start = torch.cat([true1, srt[1:] != srt[:-1]])
    run_start = torch.cummax(torch.where(is_start, idx, -1), dim=0).values
    is_last = torch.cat([srt[:-1] != srt[1:], true1])
    run_len = (idx - run_start + 1).to(torch.float32)

    K = min(candidates, n)
    min_size = max(min(50.0, float(valid_point_num)), 1.0)
    cand_score = torch.where(is_last & (srt < n) & (run_len >= min_size), run_len, -1.0)
    cand_sz, cand_pos = _top_k_stable(cand_score, K)
    cand_roots = srt[cand_pos]
    cand_ok = cand_sz > 0
    size = torch.clamp_min(cand_sz, 0.0)

    # dense (K, n) candidate membership; every statistic reduces over it
    onehot = (lab[None, :] == cand_roots[:, None]) & cand_ok[:, None]
    line_count = onehot.reshape(K, H, W).any(dim=2).sum(dim=1).to(torch.float32)
    z = points[..., 2].reshape(-1)
    r = ranges.reshape(-1)
    res = residual_img.reshape(-1)
    big = 1e9
    min_z = torch.where(onehot, z[None, :], big).amin(dim=1)
    max_z = torch.where(onehot, z[None, :], -big).amax(dim=1)
    max_dist = torch.where(onehot, r[None, :], -big).amax(dim=1)
    res_pos = onehot & (res > 0)[None, :]
    res_sum = torch.where(res_pos, res[None, :], 0.0).sum(dim=1)
    res_cnt = res_pos.sum(dim=1).to(torch.float32)
    avg_res = torch.where(res_cnt > 0, res_sum / torch.clamp_min(res_cnt, 1.0), 0.0)

    feasible = (size >= 50) & (line_count >= min_line_num)
    feasible = feasible | ((size >= valid_point_num) & (line_count >= valid_line_num))
    feasible = feasible & (max_dist <= max_distance)
    dz = max_z - min_z
    feasible = feasible & (min_delta_z <= dz) & (dz <= max_delta_z)
    feasible = feasible & ((min_z - sensor_height) <= max_elevation)
    feasible = feasible & cand_ok & (size > 0)

    top_sz, top_idx = _top_k_stable(torch.where(feasible, size, -1.0), max_objects)
    slot_valid = top_sz > 0
    slot_roots = torch.where(slot_valid, cand_roots[top_idx], -1).to(torch.int32)
    slot_avg_res = torch.where(slot_valid, avg_res[top_idx], 0.0)

    # pixel -> slot: a pixel belongs to at most one valid slot's root
    in_slot = (lab[None, :] == slot_roots[:, None]) & slot_valid[:, None]  # (S, n)
    pixel_slot = torch.where(in_slot.any(dim=0), torch.argmax(in_slot.to(torch.int32), dim=0), -1)
    return slot_roots, slot_valid, pixel_slot.to(torch.int32).reshape(H, W), slot_avg_res

"""Ground removal and range-image segmentation (counterpart of
``ops/segmentation.py``): ``groundRemoval`` (detection.cpp:448-508) as a
shifted-row stencil, ``labelComponents`` (:544-724) as iterated run-min
sweeps, and the fused per-segment gates + slot compaction of
``segment_objects`` (:659-699): on the card the hand-written
``csrc/segment_objects.cu``, on the CPU its plain version
:func:`segment_objects_plain`.

Labels equal the JAX package's bit for bit: a label is the smallest flat
pixel index of its component. One sweep takes, for every pixel, the
minimum over its maximal connected row run (columns wrap around the
ring: the runs touching column 0 and column W-1 merge where the seam
edge holds) and then over its maximal connected column run (rows do not
wrap). The JAX package computes these run minima with packed cummax
scans; here each run gets an id (a cumulative count of breaks along the
axis) and one scatter-min + gather per axis does the same. The loop
stops, as in the JAX package, when a sweep changes nothing or after
``max_iters`` sweeps: a ``core/control.while_loop`` whose test, a
``control.Test`` (the sweep count under ``max_iters`` and any label
changed), is one kernel launch inside a captured graph, so no sweep
reads the host. Each call adds its sweeps to the device count
``ccl_sweeps`` (``utils.profiling.count``); :data:`SWEEPS` counts the
eager driver's reads of the flag.
"""

from __future__ import annotations

import collections
import math
from typing import NamedTuple, Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.ops.projection import norm2
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

_BIG = 2**30
_RAD2DEG = 180.0 / math.pi

# label_components' host reads ("host_reads": the eager driver's reads of
# the stop flag, one per sweep and one before the first; none in a graph)
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
    rad = torch.full((), deg, dtype=torch.float32, device=device) * (math.pi / 180.0)
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
    wrap: bool = True,
) -> SegmentationResult:
    """Angle-predicate connected components: pixels join when
    atan2(d2 sin a, d1 - d2 cos a) > theta for neighbors at ranges d1 >= d2
    (labelComponents, detection.cpp:544-724). ``window``: optional (H, W)
    bool restricting segmentation (the fork's 156..356 box). ``wrap``:
    columns 0 and W-1 are neighbours (a 360 deg scan); a camera's image
    has no seam."""
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
    e_up[0].fill_(False)  # vertical edges don't wrap (detection.cpp:591)
    e_left = edge(1, *_sin_cos_deg(ang_res_x_deg, dev))  # col 0 <-> W-1 wraps
    if not wrap:
        e_left[:, 0].fill_(False)

    # row runs: key = breaks so far along the row; the seam edge merges the
    # run of column W-1 into the run of column 0
    m_row = e_left.clone()
    m_row[:, 0].fill_(False)
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
    prev = L + 1
    it = torch.zeros((), dtype=torch.int32, device=dev)

    def more(L, prev, it):
        return control.Test(it, max_iters, differ=(L, prev))

    def sweep(L, prev, it):
        prev.copy_(L)
        L.copy_(_run_min(_run_min(L, row_ids, n_row_ids), col_ids, n_col_ids))
        it.add_(1)

    reads = control.PREDICATE_READS["while"]
    control.while_loop(more, sweep, (L, prev, it))
    SWEEPS["host_reads"] += control.PREDICATE_READS["while"] - reads
    profiling.count(dev, "ccl_sweeps", it)  # on the device: a replay counts
    labels = torch.where(eligible, L.reshape(H, W), -1)
    return SegmentationResult(labels, e_up, e_left)


def _top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest, ties toward the lower index."""
    vals, pos = torch.sort(x, descending=True, stable=True)
    return vals[:k], pos[:k]


class SegmentStats(NamedTuple):
    """Per-root statistics + feasibility (flat arrays indexed by root id)."""

    size: torch.Tensor  # (H*W,)
    line_count: torch.Tensor
    min_z: torch.Tensor
    max_z: torch.Tensor
    max_dist: torch.Tensor
    avg_residuum: torch.Tensor
    feasible: torch.Tensor  # (H*W,) bool


def segment_stats(
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
) -> SegmentStats:
    """The exact per-root feasibility gates of labelComponents
    (detection.cpp:659-699) over every root: the oracle of
    :func:`segment_objects`, which computes them for candidate roots only.
    Reductions run over all member pixels (the reference tracks them over
    BFS edges); the size gate is the reference's hardcoded 50."""
    H, W = labels.shape
    n = H * W
    dev = labels.device
    lab = labels.reshape(-1)
    member = lab >= 0
    seg = torch.where(member, lab, n).long()

    rows_of = torch.arange(H, device=dev).repeat_interleave(W)
    present = torch.zeros(((n + 1) * H,), dtype=torch.bool, device=dev)
    present.index_fill_(0, seg * H + rows_of, True)
    line_count = present.reshape(n + 1, H).sum(dim=1).to(torch.float32)[:n]

    z = points[..., 2].reshape(-1)
    r = ranges.reshape(-1)
    res = residual_img.reshape(-1)
    res_pos = member & (res > 0)
    sum_data = torch.stack(
        [member.to(torch.float32), torch.where(res_pos, res, 0.0), res_pos.to(torch.float32)], dim=-1
    )
    sums = torch.zeros((n + 1, 3), dtype=torch.float32, device=dev).index_add_(0, seg, sum_data)[:n]
    size, res_sum, res_cnt = sums[:, 0], sums[:, 1], sums[:, 2]
    big = 1e9
    min_data = torch.where(member[:, None], torch.stack([z, -z, -r], dim=-1), big)
    # an empty segment's minimum is +inf, as jax.ops.segment_min leaves it
    mins = torch.full((n + 1, 3), torch.inf, dtype=torch.float32, device=dev).scatter_reduce_(
        0, seg[:, None].expand(-1, 3), min_data, "amin"
    )[:n]
    min_z, max_z, max_dist = mins[:, 0], -mins[:, 1], -mins[:, 2]
    avg_res = torch.where(res_cnt > 0, res_sum / torch.clamp_min(res_cnt, 1.0), 0.0)

    feasible = (size >= 50) & (line_count >= min_line_num)
    feasible = feasible | ((size >= valid_point_num) & (line_count >= valid_line_num))
    feasible = feasible & (max_dist <= max_distance)
    dz = max_z - min_z
    feasible = feasible & (min_delta_z <= dz) & (dz <= max_delta_z)
    feasible = feasible & ((min_z - sensor_height) <= max_elevation)
    feasible = feasible & (size > 0)
    return SegmentStats(size, line_count, min_z, max_z, max_dist, avg_res, feasible)


def compact_segments(
    labels: torch.Tensor, stats: SegmentStats, max_objects: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pack the largest ``max_objects`` feasible roots into object slots:
    slot_roots (S,) int32 (-1 = empty), slot_valid (S,), pixel_slot (H, W)
    int32 (-1 = none)."""
    H, W = labels.shape
    n = H * W
    top_sz, top_roots = _top_k_stable(torch.where(stats.feasible, stats.size, -1.0), max_objects)
    slot_valid = top_sz > 0
    slot_roots = torch.where(slot_valid, top_roots, -1).to(torch.int32)
    root_to_slot = torch.full((n + 1,), -1, dtype=torch.int32, device=labels.device)
    root_to_slot[torch.where(slot_valid, top_roots, n)] = torch.arange(
        max_objects, dtype=torch.int32, device=labels.device
    )
    lab = labels.reshape(-1)
    pixel_slot = torch.where(lab >= 0, root_to_slot[torch.where(lab >= 0, lab, 0).long()], -1)
    return slot_roots, slot_valid, pixel_slot.reshape(H, W)


# the residual sum's lanes: pixel p is summed in lane p mod SUM_LANES
# (csrc/segment_objects.cu kLanes; ddlo_segment_objects_lanes)
SUM_LANES = 2048


def _segment_args(labels, valid_point_num, candidates):
    H, W = labels.shape
    n = H * W
    K = min(candidates, n)
    # the JAX package's f32 bar: min(50, valid_point_num), at least 1
    min_size = math.ceil(max(min(50.0, float(valid_point_num)), 1.0))
    return H, W, n, K, min_size


def segment_objects_plain(
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
    """Plain PyTorch version of ``csrc/segment_objects.cu``, same contract
    as :func:`segment_objects`: per-root sizes by an index add; the roots
    of at least the minimum size ordered by (size descending, root
    ascending) and the first ``candidates`` kept; their statistics by
    scatters through a root -> candidate map (exact in any order but the
    residual sum, whose order the kernel's note writes out: lane p mod
    :data:`SUM_LANES` sums in ascending p, then a halving tree over the
    lanes); the gates; the first ``max_objects`` feasible candidates in
    candidate order become slots. Adds the qualifying roots to the count
    ``seg_roots`` (``utils.profiling.count``)."""
    H, W, n, K, min_size = _segment_args(labels, valid_point_num, candidates)
    S = max_objects
    dev = labels.device
    lab = labels.reshape(-1).long()
    seg = torch.where(lab >= 0, lab, n)
    size = torch.zeros((n + 1,), dtype=torch.int64, device=dev).index_add_(
        0, seg, torch.ones_like(seg))[:n]
    qual = size >= min_size
    profiling.count(dev, "seg_roots", qual.sum())

    # candidates: lax.top_k's order over the roots (a stable sort of the
    # sizes, ties to the lower root)
    top_sz, top_roots = torch.sort(torch.where(qual, size, -1), descending=True, stable=True)
    cand_sz, cand_roots = top_sz[:K], top_roots[:K]
    cand_ok = cand_sz > 0
    # root -> candidate (K = none; entry n + 1 takes the empty candidates)
    cand_of = torch.full((n + 2,), K, dtype=torch.int64, device=dev)
    cand_of.scatter_(0, torch.where(cand_ok, cand_roots, n + 1), torch.arange(K, device=dev))
    pc = cand_of[seg]  # each pixel's candidate

    # statistics, row K a dump
    rows = torch.arange(n, device=dev) // W
    present = torch.zeros(((K + 1) * H,), dtype=torch.bool, device=dev)
    present.index_fill_(0, pc * H + rows, True)
    line_count = present.reshape(K + 1, H).sum(dim=1).to(torch.float32)[:K]
    z = points[..., 2].reshape(-1)
    r = ranges.reshape(-1)
    res = residual_img.reshape(-1)
    big = 1e9

    def extent(x, fill, how):
        return torch.full((K + 1,), fill, dtype=torch.float32, device=dev).scatter_reduce_(
            0, pc, x, how, include_self=True)[:K]

    min_z, max_z, max_dist = extent(z, big, "amin"), extent(z, -big, "amax"), extent(r, -big, "amax")
    res_pos = res > 0
    res_cnt = torch.zeros((K + 1,), dtype=torch.int64, device=dev).index_add_(
        0, pc, res_pos.to(torch.int64))[:K].to(torch.float32)
    # the residual sum: each lane's adds in ascending p (one add per lane
    # and chunk), then the halving tree
    L = SUM_LANES
    lanes = torch.zeros(((K + 1) * L,), dtype=torch.float32, device=dev)
    v = torch.where(res_pos, res, 0.0)
    for p0 in range(0, n, L):
        c = pc[p0 : p0 + L]
        lanes.index_add_(0, c * L + torch.arange(c.shape[0], device=dev), v[p0 : p0 + L])
    lanes = lanes.reshape(K + 1, L)[:K]
    while lanes.shape[1] > 1:
        h = lanes.shape[1] // 2
        lanes = lanes[:, :h] + lanes[:, h:]
    res_sum = lanes[:, 0]
    avg_res = torch.where(res_cnt > 0, res_sum / torch.clamp_min(res_cnt, 1.0), 0.0)

    size = torch.clamp_min(cand_sz, 0).to(torch.float32)
    feasible = (size >= 50) & (line_count >= min_line_num)
    feasible = feasible | ((size >= valid_point_num) & (line_count >= valid_line_num))
    feasible = feasible & (max_dist <= max_distance)
    dz = max_z - min_z
    feasible = feasible & (min_delta_z <= dz) & (dz <= max_delta_z)
    feasible = feasible & ((min_z - sensor_height) <= max_elevation)
    feasible = feasible & cand_ok & (size > 0)

    # slots: the feasible candidates in candidate order (sizes descending,
    # ties to the lower root), the first S of them; slot S a dump
    rank = torch.cumsum(feasible.to(torch.int64), dim=0) - 1
    slot = torch.where(feasible & (rank < S), rank, S)
    slot_roots = torch.full((S + 1,), -1, dtype=torch.int64, device=dev).scatter_(0, slot, cand_roots)
    slot_avg = torch.zeros((S + 1,), dtype=torch.float32, device=dev).scatter_(0, slot, avg_res)
    slot_roots, slot_avg = slot_roots[:S], slot_avg[:S]
    slot_valid = torch.arange(S, device=dev) < feasible.sum()
    slot_roots = torch.where(slot_valid, slot_roots, -1).to(torch.int32)
    slot_avg = torch.where(slot_valid, slot_avg, 0.0)
    slot_of = torch.cat([torch.where(slot < S, slot, -1), torch.full((1,), -1, dtype=torch.int64, device=dev)])
    pixel_slot = slot_of[pc].to(torch.int32).reshape(H, W)
    return slot_roots, slot_valid, pixel_slot, slot_avg


def _segment_objects_card(labels, ranges, points, residual_img, sensor_height, min_line_num,
                          valid_point_num, valid_line_num, max_distance, min_delta_z, max_delta_z,
                          max_elevation, max_objects, candidates):
    """``csrc/segment_objects.cu``: one ``ddlo_segment_objects`` call (a
    memset and four kernels), counted as ``segment_objects``; raises on a
    refused launch or an input it cannot take."""
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    lib = nn_cuda.build()["segment_objects"].lib
    H, W, n, K, min_size = _segment_args(labels, valid_point_num, candidates)
    S = max_objects
    dev = labels.device
    if lib.ddlo_segment_objects_lanes() != SUM_LANES:
        raise RuntimeError("segment_objects: the kernel's residual lanes differ from SUM_LANES")
    if not 1 <= K <= lib.ddlo_segment_objects_max_candidates() or S < 1:
        raise ValueError(f"segment_objects: {K} candidates (1..{lib.ddlo_segment_objects_max_candidates()}) "
                         f"and {S} slots (at least 1) on the card")
    ins = dict(labels=(labels, torch.int32, (H, W)), points=(points, torch.float32, (H, W, 3)),
               ranges=(ranges, torch.float32, (H, W)), residual_img=(residual_img, torch.float32, (H, W)),
               sensor_height=(sensor_height, torch.float32, ()))
    for name, (x, dtype, shape) in ins.items():
        if not isinstance(x, torch.Tensor) or x.device != dev or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"segment_objects: {name} must be a {dtype} tensor of shape {shape} on {dev}")
    work = torch.empty((lib.ddlo_segment_objects_work_words(n, K),), dtype=torch.int32, device=dev)
    slot_roots = torch.empty((S,), dtype=torch.int32, device=dev)
    slot_valid = torch.empty((S,), dtype=torch.bool, device=dev)
    slot_avg = torch.empty((S,), dtype=torch.float32, device=dev)
    pixel_slot = torch.empty((H, W), dtype=torch.int32, device=dev)
    nn_cuda.run_kernel(
        lib.ddlo_segment_objects, "segment_objects", labels.contiguous(), points.contiguous(),
        ranges.contiguous(), residual_img.contiguous(), sensor_height, H, W, K, S, min_size,
        min_line_num, valid_point_num, valid_line_num, max_distance, min_delta_z, max_delta_z,
        max_elevation, work, profiling.count_cell(dev, "seg_roots"), slot_roots, slot_valid,
        slot_avg, pixel_slot,
    )
    return slot_roots, slot_valid, pixel_slot, slot_avg


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
    JAX package's ``segment_objects``): per-root sizes; the
    top-``candidates`` roots passing the minimum size (size descending,
    ties to the lower root); their distinct rows, z extent, largest range
    and mean positive residual; the gates of detection.cpp:659-699
    (including the hardcoded size 50); the largest ``max_objects``
    feasible candidates become slots. Each call adds the roots passing
    the minimum size to the device count ``seg_roots``, which says
    whether the candidate budget binds.

    CUDA tensors launch ``csrc/segment_objects.cu`` (or raise), CPU
    tensors run :func:`segment_objects_plain`; both give the same bits.

    Returns slot_roots (S,) int32 (-1 = empty), slot_valid (S,),
    pixel_slot (H, W) int32 (-1 = none), slot_avg_residuum (S,)."""
    args = (labels, ranges, points, residual_img, sensor_height, min_line_num, valid_point_num,
            valid_line_num, max_distance, min_delta_z, max_delta_z, max_elevation, max_objects,
            candidates)
    if labels.is_cuda:
        return _segment_objects_card(*args)
    return segment_objects_plain(*args)

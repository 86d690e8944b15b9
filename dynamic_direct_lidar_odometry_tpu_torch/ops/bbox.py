"""Oriented bounding boxes (counterpart of ``ops/bbox.py``): the per-slot
PCA fit of ``DetectionModule::getObject`` (detection.cpp:726-782) and the
Sutherland-Hodgman OBB IoU of ``include/util/bbox_iou.h:55-155`` in
fixed-size polygon buffers. As in the reference, the state's
``sin(yaw/2)`` entry is used directly as the rectangle's angle.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.ops.projection import norm2


class Objects(NamedTuple):
    """Fixed-slot detection list (the reference's detected_objects_)."""

    state: torch.Tensor  # (S, 7) [cx, cy, cz, sin(yaw/2), l, w, h]
    num_points: torch.Tensor  # (S,)
    density: torch.Tensor  # (S,)
    avg_residuum: torch.Tensor  # (S,)
    valid: torch.Tensor  # (S,) bool


def _eigh2(a, b, c):
    """Eigendecomposition of symmetric [[a, b], [b, c]], ascending: (w0,
    w1, v0, v1), v0 the eigenvector of the smaller eigenvalue."""
    half_tr = 0.5 * (a + c)
    s = torch.sqrt(torch.clamp_min(0.25 * (a - c) ** 2 + b * b, 0.0))
    w0, w1 = half_tr - s, half_tr + s
    use_b = torch.abs(b) > 1e-12
    a_le_c = a <= c
    v0 = torch.stack(
        [
            torch.where(use_b, b, torch.where(a_le_c, 1.0, 0.0)),
            torch.where(use_b, w0 - a, torch.where(a_le_c, 0.0, 1.0)),
        ],
        dim=-1,
    )
    v0 = v0 / torch.clamp_min(norm2(v0), 1e-12)[..., None]
    v1 = torch.stack([-v0[..., 1], v0[..., 0]], dim=-1)
    return w0, w1, v0, v1


def pca_bboxes(
    points: torch.Tensor,  # (H, W, 3) world frame
    pixel_slot: torch.Tensor,  # (H, W) int32 slot id, -1 = none
    slot_valid: torch.Tensor,  # (S,)
    avg_residuum: torch.Tensor,  # (S,)
    max_objects: int,
    max_dim_ratio: float,
) -> Objects:
    """An oriented box per object slot (computeAllObjects + getObject,
    detection.cpp:726-818) with the dimension-ratio gate
    (detection.cpp:800-804): moment sums as one dense (S, N) matmul,
    extents as masked (S, N) reductions in each slot's PCA frame."""
    S = max_objects
    p = points.reshape(-1, 3)
    seg = pixel_slot.reshape(-1)
    onehot = seg[None, :] == torch.arange(S, dtype=seg.dtype, device=seg.device)[:, None]
    wm = onehot.to(p.dtype)
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    feats = torch.stack([torch.ones_like(px), px, py, px * px, py * py, px * py], dim=-1)
    # f32 features summed in f64, then rounded to f32: the same f32 sums on
    # every device and in any summation order. The raw-moment covariance
    # below cancels catastrophically for thin walls, so the f32 sum's
    # rounding would otherwise decide the sign of a near-zero sxy (a
    # 180-degree flip of the box frame) differently on CPU and GPU.
    sums = (wm.to(torch.float64) @ feats.to(torch.float64)).to(torch.float32)  # (S, 6)

    cnt = sums[:, 0]
    safe_cnt = torch.clamp_min(cnt, 1.0)
    mx, my = sums[:, 1] / safe_cnt, sums[:, 2] / safe_cnt
    sxx = sums[:, 3] / safe_cnt - mx * mx
    syy = sums[:, 4] / safe_cnt - my * my
    sxy = sums[:, 5] / safe_cnt - mx * my

    _, _, v0, v1 = _eigh2(sxx, sxy, syy)
    E = torch.stack([v0, v1], dim=-1)  # (S, 2, 2) columns = eigenvectors
    mu = torch.stack([mx, my], dim=-1)
    dx = px[None, :] - mx[:, None]
    dy = py[None, :] - my[:, None]
    q0 = v0[:, 0:1] * dx + v0[:, 1:2] * dy  # (S, N)
    q1 = v1[:, 0:1] * dx + v1[:, 1:2] * dy

    big = 1e9

    def smin(v):
        return torch.where(onehot, v, big).amin(dim=1)

    def smax(v):
        return torch.where(onehot, v, -big).amax(dim=1)

    qx_min, qx_max = smin(q0), smax(q0)
    qy_min, qy_max = smin(q1), smax(q1)
    z_min, z_max = smin(pz[None, :]), smax(pz[None, :])

    mean_q = 0.5 * torch.stack([qx_max + qx_min, qy_max + qy_min], dim=-1)
    center_xy = (E @ mean_q[:, :, None])[:, :, 0] + mu
    center_z = 0.5 * (z_max + z_min)
    yaw = torch.atan2(v0[:, 1], v0[:, 0])  # detection.cpp:770
    dims = torch.stack([qx_max - qx_min, qy_max - qy_min, z_max - z_min], dim=-1)
    state = torch.cat(
        [center_xy, center_z[:, None], torch.sin(yaw / 2.0)[:, None], dims], dim=-1
    )
    volume = torch.clamp_min(dims[:, 0] * dims[:, 1] * dims[:, 2], 1e-9)
    density = cnt / volume
    ds = torch.sort(dims, dim=-1).values  # ascending
    ratio_ok = ds[:, 2] / torch.clamp_min(ds[:, 1], 1e-9) < max_dim_ratio
    valid = slot_valid & (cnt > 0) & ratio_ok

    zeros = torch.zeros_like(cnt)
    return Objects(
        state=torch.where(valid[:, None], state, 0.0),
        num_points=torch.where(valid, cnt, zeros),
        density=torch.where(valid, density, zeros),
        avg_residuum=torch.where(valid, avg_residuum, zeros),
        valid=valid,
    )


# ---------------------------------------------------------------------------
# OBB IoU (bbox_iou.h), batched over box pairs
# ---------------------------------------------------------------------------

_PMAX = 16  # intersection of two rectangles has <= 8 vertices


def _rect_vertices(cx, cy, w, h, r):
    """(B, 4, 2) corners (bbox_iou.h:55-71; r used directly as radians)."""
    dx, dy = w / 2.0, h / 2.0
    cr, sr = torch.cos(r), torch.sin(r)
    dxc, dxs = dx * cr, dx * sr
    dyc, dys = dy * cr, dy * sr
    vx = torch.stack([-dxc + dys, dxc + dys, dxc - dys, -dxc - dys], dim=-1)
    vy = torch.stack([-dxs - dyc, dxs - dyc, dxs + dyc, -dxs + dyc], dim=-1)
    return torch.stack([vx + cx[:, None], vy + cy[:, None]], dim=-1)


def _intersection_area(r1, r2):
    """Sutherland-Hodgman clip of rect1 by rect2 (bbox_iou.h:73-127) for B
    pairs at once, in (B, 16, 2) vertex buffers. Each clip edge emits, per
    input vertex, [s if inside] then [intersection if crossing] through
    one-hot products, as the JAX package does."""
    v1 = _rect_vertices(*r1)
    B = v1.shape[0]
    dev, dt = v1.device, v1.dtype
    poly = torch.zeros((B, _PMAX, 2), dtype=dt, device=dev)
    poly[:, :4] = v1
    n = torch.full((B,), 4, dtype=torch.int64, device=dev)
    rect2 = _rect_vertices(*r2)
    idx = torch.arange(_PMAX, device=dev)

    for i in range(4):
        p, q = rect2[:, i], rect2[:, (i + 1) % 4]  # (B, 2)
        a = (q[:, 1] - p[:, 1])[:, None]
        b = (p[:, 0] - q[:, 0])[:, None]
        c = (q[:, 0] * p[:, 1] - q[:, 1] * p[:, 0])[:, None]
        active = idx[None, :] < n[:, None]
        vals = a * poly[..., 0] + b * poly[..., 1] + c  # (B, 16)
        nxt_idx = torch.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
        nxt = torch.gather(poly, 1, nxt_idx[..., None].expand(B, _PMAX, 2))
        nxt_vals = torch.gather(vals, 1, nxt_idx)
        keep_s = active & (vals <= 0.0)
        crossing = active & (vals * nxt_vals < 0.0)
        diff = vals - nxt_vals
        denom = torch.where(torch.abs(diff) < 1e-12, 1e-12, diff)
        t = vals / denom
        ipt = poly + (nxt - poly) * t[..., None]

        emit = keep_s.to(torch.int64) + crossing.to(torch.int64)
        offs = torch.cumsum(emit, dim=1) - emit
        new_n = emit.sum(dim=1)
        pos_s = torch.where(keep_s, offs, _PMAX)
        pos_i = torch.where(crossing, offs + keep_s.to(torch.int64), _PMAX)
        oh_s = (pos_s[..., None] == idx).to(dt)  # (B, 16 in, 16 out)
        oh_i = (pos_i[..., None] == idx).to(dt)
        poly = oh_s.transpose(1, 2) @ poly + oh_i.transpose(1, 2) @ ipt
        n = torch.where(n <= 2, 0, new_n)  # degenerate: dead polygon

    active = idx[None, :] < n[:, None]
    nxt_idx = torch.where(idx[None, :] + 1 < n[:, None], idx[None, :] + 1, 0)
    nxt = torch.gather(poly, 1, nxt_idx[..., None].expand(B, _PMAX, 2))
    cross = poly[..., 0] * nxt[..., 1] - poly[..., 1] * nxt[..., 0]
    area = 0.5 * torch.where(active, cross, 0.0).sum(dim=1)
    return torch.where(n > 2, area, 0.0)


def obb_iou_pairs(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """3D IoU of B box pairs [cx,cy,cz,sin(yaw/2),l,w,h] (bbox_iou.h:129-155)."""
    inter = _intersection_area(
        (b1[:, 0], b1[:, 1], b1[:, 4], b1[:, 5], b1[:, 3]),
        (b2[:, 0], b2[:, 1], b2[:, 4], b2[:, 5], b2[:, 3]),
    )
    min1, max1 = b1[:, 2] - b1[:, 6] / 2, b1[:, 2] + b1[:, 6] / 2
    min2, max2 = b2[:, 2] - b2[:, 6] / 2, b2[:, 2] + b2[:, 6] / 2
    h_overlap = torch.clamp_min(torch.minimum(max1, max2) - torch.maximum(min1, min2), 0.0)
    inter_vol = h_overlap * inter
    total = b1[:, 4] * b1[:, 5] * b1[:, 6] + b2[:, 4] * b2[:, 5] * b2[:, 6] - inter_vol
    iou = torch.clamp_min(inter_vol / torch.where(torch.abs(total) < 1e-12, 1e-12, total), 0.0)
    return torch.clamp_max(iou, 1.0)


def obb_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """3D IoU of two boxes."""
    return obb_iou_pairs(b1[None], b2[None])[0]


def obb_iou_matrix(det_state: torch.Tensor, trk_state: torch.Tensor) -> torch.Tensor:
    """(D, T) OBB IoU of every pair, ungated: the oracle of
    :func:`obb_iou_matrix_gated`."""
    D, T = det_state.shape[0], trk_state.shape[0]
    b1 = det_state[:, None].expand(D, T, 7).reshape(D * T, 7)
    b2 = trk_state[None].expand(D, T, 7).reshape(D * T, 7)
    return obb_iou_pairs(b1, b2).reshape(D, T)


def obb_iou_matrix_gated(
    det_state: torch.Tensor,  # (D, 7)
    trk_state: torch.Tensor,  # (T, 7)
    det_valid: torch.Tensor,  # (D,)
    trk_valid: torch.Tensor,  # (T,)
    budget: int = 256,
) -> torch.Tensor:
    """(D, T) OBB IoU matrix, clipping only the pairs that can overlap:
    valid, z-extents overlapping and XY centers within the sum of the
    circumradii; the ``budget`` closest survivors are clipped (ties toward
    the lower flat index, as ``lax.top_k``), every other pair reads 0."""
    D, T = det_state.shape[0], trk_state.shape[0]
    P = D * T
    B = min(budget, P)
    dz = torch.abs(det_state[:, None, 2] - trk_state[None, :, 2])
    z_ok = dz < 0.5 * (det_state[:, None, 6] + trk_state[None, :, 6])
    dxy = norm2(det_state[:, None, :2] - trk_state[None, :, :2])
    rad_d = 0.5 * norm2(det_state[:, 4:6])
    rad_t = 0.5 * norm2(trk_state[:, 4:6])
    xy_ok = dxy <= rad_d[:, None] + rad_t[None, :]
    gate = det_valid[:, None] & trk_valid[None, :] & z_ok & xy_ok

    score = torch.where(gate.reshape(-1), -dxy.reshape(-1), -torch.inf)
    vals, sel = torch.sort(score, descending=True, stable=True)
    vals, sel = vals[:B], sel[:B]
    ok = vals > -torch.inf
    di = torch.clamp(sel // T, 0, D - 1)
    ti = torch.clamp(sel % T, 0, T - 1)
    ious = obb_iou_pairs(det_state[di], trk_state[ti])
    iou_flat = torch.zeros((P + 1,), dtype=ious.dtype, device=ious.device)
    iou_flat[torch.where(ok, sel, P)] = torch.where(ok, ious, 0.0)
    return iou_flat[:P].reshape(D, T)


"""The DLO odometry core, one state transition per scan (counterpart of
``odometry/odometry.py``): preprocessing -> scan-to-scan GICP -> submap
selection -> scan-to-submap GICP -> keyframe update.

The JAX package's ``lax.cond`` branches (the hull-cache rebuild and the
keyframe add) are ``core/control.cond`` branches on device flags: IF
nodes inside a captured graph, one predicate read outside one.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed

from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import se3
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf
from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess as prep
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, filters, gicp


class OdomState(NamedTuple):
    T: torch.Tensor  # (4,4) current pose
    T_s2s: torch.Tensor  # (4,4) S2S-propagated pose
    T_s2s_prev: torch.Tensor  # (4,4) base for next S2S propagation
    pose: torch.Tensor  # (3,)
    rotq: torch.Tensor  # (4,) [w,x,y,z]
    prev_points: torch.Tensor  # (N, 3) previous scan = next S2S target
    prev_mask: torch.Tensor  # (N,)
    prev_covs: torch.Tensor  # (N, 3, 3)
    store: kf.KeyframeStore
    spaciousness: torch.Tensor  # () LPF'd median range
    keyframe_thresh_dist: torch.Tensor  # () adaptive threshD
    prev_rel: torch.Tensor  # (4, 4) last S2S increment
    scan_count: torch.Tensor  # () int32
    # hull cache: rebuilt only when the store changed or alpha moved
    hull_cv: torch.Tensor  # (K,) bool
    hull_cc: torch.Tensor  # (K,) bool
    hull_alpha: torch.Tensor  # () f32
    hull_dirty: torch.Tensor  # () bool


class OdomOutputs(NamedTuple):
    pose: torch.Tensor
    rotq: torch.Tensor
    T: torch.Tensor
    T_s2s_rel: torch.Tensor
    reg_points_world: torch.Tensor  # (N, 3)
    reg_mask: torch.Tensor  # (N,)
    residuals: torch.Tensor  # (N,)
    new_keyframe: torch.Tensor  # () bool
    s2s_converged: torch.Tensor
    s2m_converged: torch.Tensor
    s2s_iterations: torch.Tensor
    s2m_iterations: torch.Tensor
    num_keyframes: torch.Tensor
    submap_size: torch.Tensor


def _nn_impl_from_env() -> str:
    """Correspondence backend (``DDLO_NN_IMPL``), default "sparse": the
    CUDA kernel on CUDA tensors, the exact sweep on CPU."""
    return os.environ.get("DDLO_NN_IMPL") or "sparse"


def _settings(stage, compute_residuals: bool = True) -> gicp.GICPSettings:
    return gicp.GICPSettings(
        max_correspondence_distance=stage.max_correspondence_distance,
        max_iterations=stage.max_iterations,
        rotation_epsilon=stage.rotation_epsilon,
        transformation_epsilon=stage.transformation_epsilon,
        lm_max_iterations=stage.lm_max_iterations,
        lm_init_lambda_factor=stage.lm_init_lambda_factor,
        compute_residuals=compute_residuals,
        nn_impl=_nn_impl_from_env(),
    )


def _scalar(x, dtype, dev) -> torch.Tensor:
    return torch.full((), x, dtype=dtype, device=dev)


def init_state(
    cfg: DDLOConfig,
    raw_points,
    raw_mask,
    T0=None,
    *,
    device="cuda",
) -> OdomState:
    """Initialize from the first scan: it becomes the S2S target and the
    first keyframe. ``T0`` seeds the pose (identity by default). The
    state lives on ``device``: the card unless the caller asks for the
    CPU (without a card the default raises)."""
    dev = device_mod.resolve(device)
    raw_points = torch.as_tensor(raw_points, dtype=torch.float32, device=dev)
    raw_mask = torch.as_tensor(raw_mask, dtype=torch.bool, device=dev)
    if T0 is None:
        T0 = torch.eye(4)
    T0 = torch.as_tensor(T0, dtype=torch.float32, device=dev)

    p = prep.preprocess(cfg, raw_points, raw_mask)
    covs = covariance.plane_covariances(
        p.points, p.mask, k=cfg.gicp.s2s.k_correspondences,
        morton_ordered=cfg.preprocessing.voxel_scan.use,
    )

    kf_pts_w = se3.transform_points(T0, p.points)
    kf_pts_w = torch.where(p.mask[:, None], kf_pts_w, SENTINEL)
    if cfg.preprocessing.voxel_submap.use:
        kf_pts, kf_mask = filters.voxel_downsample(
            kf_pts_w, p.mask, cfg.preprocessing.voxel_submap.res,
            cfg.capacity.max_keyframe_points,
        )
    else:
        kf_pts, kf_mask = filters.compact(
            kf_pts_w, p.mask, cfg.capacity.max_keyframe_points
        )
    kf_covs = covariance.plane_covariances(
        kf_pts, kf_mask, k=cfg.gicp.s2s.k_correspondences,
        morton_ordered=cfg.preprocessing.voxel_submap.use,
    )

    store = kf.empty_store(
        cfg.capacity.max_keyframes, cfg.capacity.max_keyframe_points, device=dev
    )
    rotq = se3.matrix_to_quat(T0[:3, :3])
    store = kf.add_keyframe(store, True, T0[:3, 3], rotq, kf_pts, kf_mask, kf_covs)
    K = cfg.capacity.max_keyframes
    return OdomState(
        T=T0,
        T_s2s=T0,
        T_s2s_prev=T0,
        pose=T0[:3, 3],
        rotq=rotq,
        prev_points=p.points,
        prev_mask=p.mask,
        prev_covs=covs,
        store=store,
        spaciousness=p.spaciousness_median,
        keyframe_thresh_dist=_scalar(cfg.keyframe.thresh_dist, torch.float32, dev),
        prev_rel=torch.eye(4, device=dev),
        scan_count=_scalar(1, torch.int32, dev),
        hull_cv=torch.zeros((K,), dtype=torch.bool, device=dev),
        hull_cc=torch.zeros((K,), dtype=torch.bool, device=dev),
        hull_alpha=_scalar(-1.0, torch.float32, dev),
        hull_dirty=_scalar(True, torch.bool, dev),
    )


def step(
    cfg: DDLOConfig,
    state: OdomState,
    raw_points: torch.Tensor,
    raw_mask: torch.Tensor,
    hull_masks: Tuple[torch.Tensor, torch.Tensor] | None = None,
    axis_name: torch.distributed.ProcessGroup | None = None,
    pt_size: int = 1,
) -> Tuple[OdomState, OdomOutputs]:
    """One odometry step (plain DLO: the dynamicDetection=false path of
    icpCB). ``hull_masks``: optional exact (convex, concave) hull masks
    from the host; without them the on-device hulls select the submap.

    ``axis_name``/``pt_size``: point-parallel mode, on every rank of a
    ``pt`` group with the scan whole on each (``axis_name`` is that
    ``torch.distributed`` group: a mesh's ``pt_group``). Rank i takes rows
    [i N/pt, (i+1) N/pt) of the preprocessed scan: their covariances
    against the full scan (the k-NN path), gathered in rank order to full
    length for the next scan's S2S target, and their GICP linearizations,
    summed over the group inside every LM iteration; the S2M residuals are
    gathered back to full length. Everything else runs on every rank."""
    dev = state.T.device
    p = prep.preprocess(cfg, raw_points, raw_mask)
    spacious = 0.95 * state.spaciousness + 0.05 * p.spaciousness_median
    kf_thresh_d = prep.adaptive_keyframe_thresh(spacious)

    N = p.points.shape[0]
    if axis_name is not None:
        from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed

        if N % pt_size != 0:
            raise ValueError(f"max_points={N} must be divisible by pt_size={pt_size}")
        group = distributed.check_group(axis_name)
        chunk = N // pt_size
        i0 = torch.distributed.get_rank(group) * chunk
        q_pts, q_msk = p.points[i0:i0 + chunk], p.mask[i0:i0 + chunk]
        q_covs = covariance.plane_covariances(
            q_pts, q_msk, k=cfg.gicp.s2s.k_correspondences, neighbor_points=p.points,
        )
        src_covs = distributed.allgather_rows(q_covs, group)
        src = (q_pts, q_msk, q_covs)
    else:
        # source covariances, shared by S2S and S2M (odom.cc:765)
        src_covs = covariance.plane_covariances(
            p.points, p.mask, k=cfg.gicp.s2s.k_correspondences,
            morton_ordered=cfg.preprocessing.voxel_scan.use,
        )
        src = (p.points, p.mask, src_covs)

    # scan-to-scan (odom.cc:754-762); no residual pass for S2S
    s2s_guess = state.prev_rel if cfg.initial_guess_motion else torch.eye(4, device=dev)
    s2s = gicp.align(
        *src, state.prev_points, state.prev_mask, state.prev_covs, s2s_guess,
        _settings(cfg.gicp.s2s, compute_residuals=False), axis_name=axis_name,
    )
    T_s2s = se3.compose(state.T_s2s_prev, s2s.T)

    # submap selection + gather (odom.cc:775-784)
    alpha = state.keyframe_thresh_dist
    if hull_masks is not None:
        cv_mask, cc_mask = hull_masks
        hull_cache = (state.hull_cv, state.hull_cc, state.hull_alpha,
                      state.hull_dirty)
    else:
        # exact on-device hulls, rebuilt only when their inputs changed
        cv_mask, cc_mask = state.hull_cv.clone(), state.hull_cc.clone()

        def rebuild(cv, cc):
            cv.copy_(kf.convex_hull_mask(state.store.positions, state.store.valid))
            cc.copy_(kf.concave_hull_mask(state.store.positions, state.store.valid, alpha))

        control.cond(state.hull_dirty | (alpha != state.hull_alpha), rebuild, None,
                     (cv_mask, cc_mask))
        hull_cache = (cv_mask, cc_mask, alpha, _scalar(False, torch.bool, dev))
    sel = kf.select_submap(
        state.store, T_s2s[:3, 3], alpha,
        cfg.submap.knn, cfg.submap.kcv, cfg.submap.kcc,
        cv_mask=cv_mask, cc_mask=cc_mask,
    )
    max_slots = min(
        cfg.submap.knn + cfg.submap.kcv + cfg.submap.kcc,
        cfg.capacity.max_keyframes,
    )
    sub_pts, sub_mask, sub_covs = kf.gather_submap(
        state.store, sel, max_slots, capacity=cfg.capacity.max_submap_points
    )

    # scan-to-submap with S2S as guess (odom.cc:787-793)
    s2m = gicp.align(
        *src, sub_pts, sub_mask, sub_covs, T_s2s, _settings(cfg.gicp.s2m),
        axis_name=axis_name,
    )
    T_new = s2m.T
    residuals = s2m.residuals
    if axis_name is not None:
        # the shard's residual slice -> full scan (the residual image)
        residuals = distributed.allgather_rows(residuals, group)
    pose = T_new[:3, 3]
    rotq = se3.matrix_to_quat(T_new[:3, :3])
    reg_world = se3.transform_points(T_new, p.points)
    reg_world = torch.where(p.mask[:, None], reg_world, SENTINEL)

    new_state = OdomState(
        T=T_new,
        T_s2s=T_s2s,
        T_s2s_prev=T_new,
        pose=pose,
        rotq=rotq,
        prev_points=p.points,
        prev_mask=p.mask,
        prev_covs=src_covs,
        store=state.store,
        spaciousness=spacious,
        keyframe_thresh_dist=kf_thresh_d,
        prev_rel=s2s.T,
        scan_count=state.scan_count + 1,
        hull_cv=hull_cache[0],
        hull_cc=hull_cache[1],
        hull_alpha=hull_cache[2],
        hull_dirty=hull_cache[3],
    )
    outputs = OdomOutputs(
        pose=pose,
        rotq=rotq,
        T=T_new,
        T_s2s_rel=s2s.T,
        reg_points_world=reg_world,
        reg_mask=p.mask,
        residuals=residuals,
        new_keyframe=_scalar(False, torch.bool, dev),
        s2s_converged=s2s.converged,
        s2m_converged=s2m.converged,
        s2s_iterations=s2s.iterations,
        s2m_iterations=s2m.iterations,
        num_keyframes=state.store.count,
        submap_size=sub_mask.sum(dtype=torch.int32),
    )
    return new_state, outputs


def gravity_align(
    accel_samples: np.ndarray,
    imu_lidar_quat: Tuple[float, float, float, float] | None = None,
) -> np.ndarray:
    """Initial gravity-aligned pose from buffered IMU accelerations
    (OdomNode::gravityAlign, odom.cc:534-597), host numpy. Returns (4,4)
    float32 T0 with the gravity-aligned rotation and zero translation."""
    a = np.asarray(accel_samples, dtype=np.float64).mean(axis=0)
    n = np.linalg.norm(a)
    if n < 1e-9:
        return np.eye(4, dtype=np.float32)
    a = a / n
    g = np.array([0.0, 0.0, 1.0])
    w = 1.0 + float(a @ g)  # Eigen::Quaternion::FromTwoVectors(a, g)
    if w < 1e-9:  # antiparallel: rotate pi about any orthogonal axis
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-9:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        q = np.concatenate([[0.0], axis / np.linalg.norm(axis)])
    else:
        q = np.concatenate([[w], np.cross(a, g)])
        q = q / np.linalg.norm(q)
    if imu_lidar_quat is not None:
        # the JAX package composes in f32
        qe = torch.tensor(imu_lidar_quat, dtype=torch.float32)
        q = se3.quat_mul(torch.tensor(q, dtype=torch.float32), qe).double().numpy()
        q = q / np.linalg.norm(q)
    R = se3.quat_to_matrix(torch.tensor(q, dtype=torch.float32)).numpy()
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = R
    return T0


def keyframe_decision(
    cfg: DDLOConfig, state: OdomState, pose: torch.Tensor, rotq: torch.Tensor
) -> torch.Tensor:
    """updateKeyframes decision logic (odom.cc:1067-1127)."""
    store = state.store
    d = torch.linalg.vector_norm(store.positions - pose, dim=1)
    d = torch.where(store.valid, d, torch.inf)
    thresh = state.keyframe_thresh_dist
    num_nearby = torch.sum((d <= thresh * 1.5) & store.valid)
    closest = torch.argmin(d).reshape(1)
    dd = d.index_select(0, closest)[0]
    dq = se3.quat_mul(rotq, se3.quat_conj(store.quats.index_select(0, closest)[0]))
    theta_deg = se3.quat_angle_deg(dq)

    # far enough, or turned enough with at most one keyframe nearby
    far = torch.abs(dd) > thresh
    turned = torch.abs(theta_deg) > cfg.keyframe.thresh_rot
    return far | (turned & (num_nearby <= 1))


def update_keyframes(
    cfg: DDLOConfig,
    state: OdomState,
    world_points: torch.Tensor,
    world_mask: torch.Tensor,
    refilter: bool = False,
) -> Tuple[OdomState, torch.Tensor]:
    """Conditionally add the current world-frame scan as a keyframe
    (odom.cc:1067-1154): one voxel pass at submap resolution (when both
    voxel filters are on, the scan-resolution re-filter is folded into
    it, as in the JAX package). Returns (state', added?); the store is
    written in place: a copy of the caller's, which stays as it was."""
    new_kf = keyframe_decision(cfg, state, state.pose, state.rotq)
    store = kf.clone_store(state.store)

    def insert(*fields):
        pre = cfg.preprocessing
        pts_in, mask_in = world_points, world_mask
        if refilter and not (pre.voxel_scan.use and pre.voxel_submap.use):
            if pre.voxel_scan.use:
                pts_in, mask_in = filters.voxel_downsample(
                    pts_in, mask_in, pre.voxel_scan.res, cfg.capacity.max_points
                )
            else:
                pts_in, mask_in = filters.compact(
                    pts_in, mask_in, cfg.capacity.max_points
                )
        if pre.voxel_submap.use:
            pts, mask = filters.voxel_downsample(
                pts_in, mask_in, pre.voxel_submap.res,
                cfg.capacity.max_keyframe_points,
            )
        else:
            pts, mask = filters.compact(
                pts_in, mask_in, cfg.capacity.max_keyframe_points
            )
        covs = covariance.plane_covariances(
            pts, mask, k=cfg.gicp.s2s.k_correspondences,
            morton_ordered=pre.voxel_submap.use,
        )
        kf.insert_keyframe_(kf.KeyframeStore(*fields), state.pose, state.rotq, pts, mask, covs)

    control.cond(new_kf, insert, None, tuple(store))
    return (
        state._replace(store=store, hull_dirty=state.hull_dirty | new_kf),
        new_kf,
    )

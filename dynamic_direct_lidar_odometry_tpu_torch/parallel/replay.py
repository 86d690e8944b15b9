"""Replay of B independent scan streams (counterpart of
``parallel/replay.py``): multi-robot fleets, config sweeps and dataset
re-processing, with only the pose trail brought back to the host."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding


@dataclasses.dataclass
class BatchReplayResult:
    poses: np.ndarray  # (B, S-1, 3)
    quats: np.ndarray  # (B, S-1, 4)
    num_keyframes: np.ndarray  # (B,)
    final_states: pipeline.DDLOState  # batched: every leaf with a leading B


def replay_batch(
    cfg: DDLOConfig,
    points: np.ndarray,  # (B, S, HW, 3)
    masks: np.ndarray,  # (B, S, HW)
    stamps: np.ndarray,  # (B, S)
    mesh: Optional[sharding.Mesh] = None,
) -> BatchReplayResult:
    """Replay B streams of S scans each on the mesh's card (default
    ``sharding.make_mesh()``: the card). Each scan step advances every
    stream at once through :func:`sharding.batched_pipeline_step` (on the
    card one graph replay per step; each scan uploaded from pinned memory
    without blocking the host). The host reads nothing back until the
    end, where the pose trail and the keyframe counts come back once."""
    mesh = mesh if mesh is not None else sharding.make_mesh()
    dev = mesh.device
    stamps = np.asarray(stamps, np.float32)
    state = sharding.batched_init_state(
        cfg, points[:, 0], masks[:, 0], stamps[:, 0], device=dev
    )
    step = sharding.batched_pipeline_step(cfg, mesh)

    def upload(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
        return (x.pin_memory() if dev.type == "cuda" else x).to(dev, non_blocking=True)

    poses, quats = [], []
    for s in range(1, points.shape[1]):
        state, out = step(state, upload(points[:, s]), upload(masks[:, s]), upload(stamps[:, s]))
        poses.append(out.odom.pose)
        quats.append(out.odom.rotq)
    return BatchReplayResult(
        poses=torch.stack(poses, dim=1).cpu().numpy(),
        quats=torch.stack(quats, dim=1).cpu().numpy(),
        num_keyframes=state.odom.store.valid.sum(dim=-1, dtype=torch.int32).cpu().numpy(),
        final_states=state,
    )

"""Batches of independent registrations and odometry streams on one card
(counterpart of ``parallel/sharding.py``).

The JAX package shards B streams over a ``dp`` mesh axis and the points of
one registration over a ``pt`` axis. Here the mesh is one device and the
``dp`` axis is a leading batch dimension on every tensor. Point-parallel
alignment (``pt > 1``, its normal equations all-reduced inside every LM
iteration) needs ``torch.distributed`` and is not ported (ROADMAP.md
queue 1 item 1).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import tree
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

DP_AXIS = "dp"
PT_AXIS = "pt"


class Mesh(NamedTuple):
    """A (dp, pt) mesh; on one card ``devices`` holds that card and
    ``shape`` is ``{"dp": 1, "pt": 1}``."""

    devices: tuple
    shape: dict

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(
    n_devices: Optional[int] = None,
    pt: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A mesh over one device (``devices[0]``, default the card): the
    batch axis of every call lives there. ``n_devices`` must be 1 and
    ``pt`` 1; point-parallel and multi-card meshes raise."""
    devs = [device_mod.resolve(d) for d in (devices if devices is not None else ["cuda"])]
    n = 1 if n_devices is None else n_devices
    if pt != 1:
        raise NotImplementedError(
            f"point-parallel mesh (pt={pt}) is not ported: it needs torch.distributed "
            "(ROADMAP.md queue 1 item 1)"
        )
    if n != 1 or len(devs) != 1:
        raise NotImplementedError(
            f"a mesh of {n} devices is not ported: the batch axis lives on one card"
        )
    return Mesh(devices=tuple(devs), shape={DP_AXIS: 1, PT_AXIS: 1})


def shard_batch(mesh: Mesh, batch: Any, point_sharded_leaves=()) -> Any:
    """Place a batched container (or tensor / array) on the mesh's device."""
    return tree.map_leaves(lambda x: torch.as_tensor(x).to(mesh.device), batch)


def batched_align(
    mesh: Mesh,
    settings: gicp.GICPSettings = gicp.GICPSettings(),
    point_sharded: bool = False,
):
    """A batch-of-registrations aligner on the mesh's card: call it with
    (src_pts (B,N,3), src_mask (B,N), src_covs (B,N,3,3), tgt_pts (B,M,3),
    tgt_mask (B,M), tgt_covs (B,M,3,3), guess (B,4,4)) and get a
    ``GICPResult`` with a leading B (:func:`gicp.align_batch`: every LM
    iteration linearizes all streams at once, one batched sparse 1-NN
    launch for the whole batch)."""
    if point_sharded:
        raise NotImplementedError(
            "point-sharded align is not ported: it needs torch.distributed (ROADMAP.md queue 1 item 1)"
        )

    def align(src_pts, src_mask, src_covs, tgt_pts, tgt_mask, tgt_covs, guess):
        args = shard_batch(mesh, (src_pts, src_mask, src_covs, tgt_pts, tgt_mask, tgt_covs, guess))
        return gicp.align_batch(*args, settings)

    return align


def batched_init_state(cfg: DDLOConfig, raw_points, raw_mask, stamps, *, device="cuda"):
    """``pipeline.init_state`` of each of B streams, stacked into one
    batched state (every leaf with a leading B) on ``device``."""
    return tree.stack([
        pipeline.init_state(cfg, p, m, float(t), device=device)
        for p, m, t in zip(raw_points, raw_mask, stamps)
    ])


def batched_pipeline_step(cfg: DDLOConfig, mesh: Mesh):
    """A batch-of-streams DDLO transition: call it with (states, raw_points
    (B,HW,3), raw_mask (B,HW), stamps (B,)) and get (states', outputs),
    each stacked over B.

    The streams advance one after another through ``pipeline.step`` on
    the mesh's card: the step still reads the host per stream (the LM
    loops, the JV solve, the keyframe insert), so a truly batched step
    waits for sync-free loops (ROADMAP.md queue 1 items 4-5)."""

    def step(states, raw_points, raw_mask, stamps):
        raw_points, raw_mask, stamps = shard_batch(mesh, (raw_points, raw_mask, stamps))
        results = [
            pipeline.step(cfg, tree.index(states, b), raw_points[b], raw_mask[b], stamps[b])
            for b in range(raw_points.shape[0])
        ]
        new_states, outputs = zip(*results)
        return tree.stack(new_states), tree.stack(outputs)

    return step

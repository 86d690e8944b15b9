"""Batches of registrations and odometry streams, and point-parallel
alignment over ranks (counterpart of ``parallel/sharding.py``).

The JAX package shards B streams over a ``dp`` mesh axis and the points
of one registration over a ``pt`` axis. Here a mesh is a grid of
``torch.distributed`` ranks, one device each: rank r sits at
(dp, pt) = (r // pt, r % pt), and each ``dp`` row's ``pt`` ranks share a
process group. On one rank the ``dp`` axis is a leading batch dimension
on every tensor. Along ``pt`` each rank aligns its N/pt source rows
against the whole target, and the normal equations, errors and inlier
counts are summed over the group inside every LM iteration
(``distributed.allsum``: rank order, the same bits on every rank).

On the card the batch modes are captured CUDA graphs, the port's
``jax.jit(shard_map(vmap(...)))``: :func:`batched_align`'s aligner
replays a graph of ``gicp.align_batch`` (its loops conditional nodes
over "any stream still running"), and :func:`batched_pipeline_step` a
graph whose B streams are B independent branches
(``core/control.branches``), each the single-stream step
``pipeline._step``; one graph per static signature
(:func:`graph_stats`, :func:`clear_graphs`), replayed with no host read.
The CPU and the point-parallel modes (gloo collectives cannot be
captured) run eagerly.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from dynamic_direct_lidar_odometry_tpu_torch import pipeline
from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import tree as tree_mod
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp
from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed

DP_AXIS = "dp"
PT_AXIS = "pt"
# the batch modes' captured graphs (apart from pipeline's, so that they
# never evict the single-stream step's)
MAX_GRAPHS = 4
_GRAPHS = control.GraphCache(MAX_GRAPHS)


class Mesh(NamedTuple):
    """A (dp, pt) mesh seen from one rank: ``devices`` holds this rank's
    device, ``shape`` the axis sizes, ``dp_index`` / ``pt_index`` the
    rank's place and ``pt_group`` its row's process group (None when
    ``pt`` is 1)."""

    devices: tuple
    shape: dict
    dp_index: int = 0
    pt_index: int = 0
    pt_group: Any = None

    @property
    def device(self) -> torch.device:
        return self.devices[0]


def make_mesh(
    n_devices: Optional[int] = None,
    pt: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (dp, pt) mesh over ``n_devices`` ranks, ``dp = n_devices // pt``
    (default: every rank of the process group, or this process alone).
    ``devices[0]`` (default the card) is this rank's device.

    More than one rank needs the process group (``distributed.initialize``)
    with exactly ``n_devices`` ranks; every rank calls this with the same
    arguments (each ``pt`` group is a ``dist.new_group``, built in dp
    order on every rank). The mesh's ``pt_group`` is what the
    point-parallel calls take (``gicp.align(axis_name=mesh.pt_group)``)."""
    devs = [device_mod.resolve(d) for d in (devices if devices is not None else ["cuda"])]
    world = distributed.process_count()
    n = world if n_devices is None else n_devices
    if n % pt != 0:
        raise ValueError(f"n_devices={n} not divisible by pt={pt}")
    if n != world:
        raise RuntimeError(
            f"a mesh of {n} devices needs torch.distributed with {n} ranks "
            f"(one device each); this process group has {world}"
        )
    dp = n // pt
    rank = distributed.process_index()
    group = None
    if pt > 1:
        for d in range(dp):  # every rank creates every group, in order
            g = dist.new_group(ranks=list(range(d * pt, (d + 1) * pt)))
            if d == rank // pt:
                group = g
    return Mesh(devices=(devs[0],), shape={DP_AXIS: dp, PT_AXIS: pt},
                dp_index=rank // pt, pt_index=rank % pt, pt_group=group)


def shard_batch(mesh: Mesh, tree: Any, point_sharded_leaves=()) -> Any:
    """Place a batched container (or tensor / array) on the mesh's device."""
    return tree_mod.map_leaves(lambda x: torch.as_tensor(x).to(mesh.device), tree)


def clear_graphs() -> None:
    """Drop every captured graph of the batch modes (and their pools)."""
    _GRAPHS.clear()


def graph_stats() -> list:
    """Per cached graph of the batch modes: its kind ("align" or
    "step"), capture seconds, the memory its capture reserved (bytes) and
    its replays."""
    return _GRAPHS.stats()


def _point_slice(mesh: Mesh, n_points: int) -> slice:
    pt = mesh.shape[PT_AXIS]
    if n_points % pt != 0:
        raise ValueError(f"{n_points} source points must divide by pt={pt}")
    k = n_points // pt
    return slice(mesh.pt_index * k, (mesh.pt_index + 1) * k)


def batched_align(
    mesh: Mesh,
    settings: gicp.GICPSettings = gicp.GICPSettings(),
    point_sharded: bool = False,
):
    """A batch-of-registrations aligner: call it with (src_pts (B,N,3),
    src_mask (B,N), src_covs (B,N,3,3), tgt_pts (B,M,3), tgt_mask (B,M),
    tgt_covs (B,M,3,3), guess (B,4,4)), the batch of this rank's ``dp``
    row, and get a ``GICPResult`` with a leading B
    (:func:`gicp.align_batch`: every LM iteration linearizes all streams
    at once, one batched sparse 1-NN launch for the whole batch).

    ``point_sharded``: each rank takes its N/pt source rows (rank order)
    against the whole target, the sums ride the row's ``pt`` group, and
    the residuals and correspondences are gathered back to full length.

    On a CUDA mesh without ``point_sharded`` the aligner replays a
    captured graph of :func:`gicp.align_batch` (one per static
    signature, captured at its first call after one eager warm-up); the
    result is a clone of the graph's outputs."""
    pt = mesh.shape[PT_AXIS] if point_sharded else 1

    def align(src_pts, src_mask, src_covs, tgt_pts, tgt_mask, tgt_covs, guess):
        args = shard_batch(mesh, (src_pts, src_mask, src_covs, tgt_pts, tgt_mask, tgt_covs, guess))
        if pt == 1 and mesh.device.type == "cuda":
            return _GRAPHS.get("align", settings, lambda *a: gicp.align_batch(*a, settings),
                               args)(*args)
        if pt == 1:
            return gicp.align_batch(*args, settings)
        sl = _point_slice(mesh, args[0].shape[1])
        res = gicp.align_batch(*(a[:, sl] for a in args[:3]), *args[3:], settings,
                               axis_name=mesh.pt_group)
        return res._replace(
            residuals=distributed.allgather_rows(res.residuals, mesh.pt_group, dim=1),
            correspondences=distributed.allgather_rows(res.correspondences, mesh.pt_group, dim=1),
        )

    return align


def batched_init_state(cfg: DDLOConfig, raw_points, raw_mask, stamps, *, device="cuda"):
    """``pipeline.init_state`` of each of B streams, stacked into one
    batched state (every leaf with a leading B) on ``device``."""
    return tree_mod.stack([
        pipeline.init_state(cfg, p, m, float(t), device=device)
        for p, m, t in zip(raw_points, raw_mask, stamps)
    ])


def batched_pipeline_step(cfg: DDLOConfig, mesh: Mesh):
    """A batch-of-streams DDLO transition: call it with (states, raw_points
    (B,HW,3), raw_mask (B,HW), stamps (B,)) and get (states', outputs),
    each stacked over B. Each stream's state and outputs are, bit for
    bit, what ``pipeline.step`` gives that stream alone.

    On a CUDA mesh a call is one replay of a captured graph (one per
    static signature, B included): the B streams are B branches of it
    (``core/control.branches``), each the single-stream step on its own
    copy of its stream's state and scan, which the card may run at once;
    the join stacks their states and outputs. On the CPU the same body
    runs eagerly, the streams one after another."""

    def body(states, raw_points, raw_mask, stamps):
        def stream(b):
            one = tree_mod.map_leaves(torch.clone, (tree_mod.index(states, b), raw_points[b],
                                                    raw_mask[b], stamps[b]))
            return pipeline._step(cfg, *one)

        new_states, outputs = zip(*control.branches(raw_points.device, raw_points.shape[0], stream))
        return tree_mod.stack(new_states), tree_mod.stack(outputs)

    def step(states, raw_points, raw_mask, stamps):
        dev = mesh.device
        args = (states, torch.as_tensor(raw_points, dtype=torch.float32, device=dev),
                torch.as_tensor(raw_mask, dtype=torch.bool, device=dev),
                torch.as_tensor(stamps, device=dev).to(torch.float32))
        if dev.type != "cuda":
            return body(*args)
        B = args[1].shape[0]
        return _GRAPHS.get("step", cfg, body, args, branches=B)(*args)

    return step


def point_parallel_pipeline_step(cfg: DDLOConfig, mesh: Mesh):
    """A batch-of-streams DDLO transition with both mesh axes live: this
    rank's ``dp`` row of streams, each stream's GICP point loops split
    over the row's ``pt`` ranks (the scan whole on every rank; the sums
    all-reduced, covariances and residuals all-gathered:
    ``odometry.step``'s point-parallel mode). Every other stage runs,
    replicated, on every rank of the row. Call like
    :func:`batched_pipeline_step`.

    The ranks' replicated stages must give every rank the same bits, or
    the ranks would sum partials linearized at different poses. So with
    ``pt > 1`` the step runs under PyTorch's deterministic algorithms (an
    op without a deterministic implementation raises; cuBLAS needs
    ``CUBLAS_WORKSPACE_CONFIG``, which ``distributed.initialize`` sets),
    and after each stream's step the ranks compare their states
    (``distributed.check_agree``) and raise if they differ."""
    pt_size = mesh.shape[PT_AXIS]
    if cfg.capacity.max_points % pt_size != 0:
        raise ValueError(
            f"capacity.max_points={cfg.capacity.max_points} must divide by pt={pt_size}"
        )
    axis = mesh.pt_group if pt_size > 1 else None

    def stream_step(state, *scan):
        new_state, out = pipeline.step(cfg, state, *scan, axis_name=axis, pt_size=pt_size)
        if axis is not None:
            distributed.check_agree(new_state, axis)
        return new_state, out

    def step(states, raw_points, raw_mask, stamps):
        raw_points, raw_mask, stamps = shard_batch(mesh, (raw_points, raw_mask, stamps))
        prev = torch.are_deterministic_algorithms_enabled(), torch.is_deterministic_algorithms_warn_only_enabled()
        fill = torch.utils.deterministic.fill_uninitialized_memory
        if axis is not None:
            torch.use_deterministic_algorithms(True)
            torch.utils.deterministic.fill_uninitialized_memory = False  # no NaN fill of torch.empty
        try:
            results = [
                stream_step(tree_mod.index(states, b), raw_points[b], raw_mask[b], stamps[b])
                for b in range(raw_points.shape[0])
            ]
        finally:
            torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
            torch.utils.deterministic.fill_uninitialized_memory = fill
        new_states, outputs = zip(*results)
        return tree_mod.stack(new_states), tree_mod.stack(outputs)

    return step

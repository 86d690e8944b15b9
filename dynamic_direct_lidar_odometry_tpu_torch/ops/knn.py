"""Exact brute-force nearest-neighbor sweeps (counterpart of ``ops/knn.py``).

Candidate selection expands ``||q||^2 + ||t||^2 - 2 q.t`` chunk by chunk
(the cross term a full-f32 matmul: TF32 is off package-wide) with a
running min / top-k merge, then the returned squared distances are
recomputed exactly as ``||q - t[idx]||^2``. These are the CPU path of
every NN call and the oracle for the CUDA kernels.

Dispatch follows the JAX package: on an accelerator ``nn1_best`` and
``knn_best`` would take the dense Pallas kernels, which are not ported
yet, so on CUDA tensors they raise instead of quietly running the sweep.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows

_BIG = 3.0e12


def nn1_best(query: torch.Tensor, target: torch.Tensor):
    """1-NN: the exact sweep on CPU. On CUDA the JAX package's dense
    ``_nn1_kernel`` path, not ported yet (ROADMAP queue 2 #2)."""
    if device.on_accelerator(query):
        raise NotImplementedError(
            "nn1_best on CUDA needs the dense 1-NN kernel (_nn1_kernel), not "
            "ported yet: ROADMAP.md queue 2 #2. Use nn_impl='sparse' (the "
            "default) or DDLO_NN_IMPL=exact."
        )
    return nn1(query, target)


def knn_best(query: torch.Tensor, target: torch.Tensor, k: int):
    """k-NN for covariance neighborhoods: the exact sweep on CPU, and on
    CUDA with ``DDLO_KNN_IMPL=exact``. Otherwise on CUDA the JAX
    package's lane-class kernel path, not ported yet (ROADMAP queue 2 #3)."""
    if (
        device.on_accelerator(query)
        and k <= 128
        and os.environ.get("DDLO_KNN_IMPL", "auto") != "exact"
    ):
        raise NotImplementedError(
            "knn_best on CUDA needs the lane-class k-NN kernels "
            "(_nn_classes_kernel / _nn_classes_sparse_kernel), not ported "
            "yet: ROADMAP.md queue 2 #3. Set DDLO_KNN_IMPL=exact for the "
            "exact sweep."
        )
    return knn(query, target, k)


def nn1(
    query: torch.Tensor,
    target: torch.Tensor,
    query_chunk: int = 1024,
    target_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force 1-NN: (idx (Q,) int32, sqdist (Q,) f32) of the nearest
    target row per query row. Invalid rows must sit at the SENTINEL; a
    sentinel query may get an index into the 1e6 target padding (>= T),
    as in the JAX package, whose gathers clamp it (callers clamp too)."""
    t = pad_rows(target, target_chunk, 1.0e6)
    t_sq = torch.sum(t * t, dim=-1)
    idx_out = []
    for q0 in range(0, query.shape[0], query_chunk):
        qc = query[q0 : q0 + query_chunk]
        q_sq = torch.sum(qc * qc, dim=-1)
        best_d = torch.full((qc.shape[0],), _BIG, device=qc.device)
        best_i = torch.zeros((qc.shape[0],), dtype=torch.int64, device=qc.device)
        for t0 in range(0, t.shape[0], target_chunk):
            tc = t[t0 : t0 + target_chunk]
            d = q_sq[:, None] + t_sq[None, t0 : t0 + target_chunk] - 2.0 * (qc @ tc.T)
            ci = torch.argmin(d, dim=1)
            cd = torch.gather(d, 1, ci[:, None])[:, 0]
            take = cd < best_d
            best_d = torch.where(take, cd, best_d)
            best_i = torch.where(take, ci + t0, best_i)
        idx_out.append(best_i)
    idx = torch.cat(idx_out) if idx_out else query.new_zeros((0,), dtype=torch.int64)
    diff = query - t[idx]
    return idx.to(torch.int32), torch.sum(diff * diff, dim=-1)


def knn(
    query: torch.Tensor,
    target: torch.Tensor,
    k: int,
    query_chunk: int = 1024,
    target_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k-NN with a running top-k merge over target chunks; a
    query contained in the target returns itself as a 0-distance
    neighbor. Returns (idx (Q, k) int32, sqdist (Q, k) f32), ascending by
    the exactly recomputed distance (stable on ties)."""
    t = pad_rows(target, target_chunk, 1.0e6)
    t_sq = torch.sum(t * t, dim=-1)
    idx_out = []
    for q0 in range(0, query.shape[0], query_chunk):
        qc = query[q0 : q0 + query_chunk]
        q_sq = torch.sum(qc * qc, dim=-1)
        best_d = torch.full((qc.shape[0], k), _BIG, device=qc.device)
        best_i = torch.zeros((qc.shape[0], k), dtype=torch.int64, device=qc.device)
        for t0 in range(0, t.shape[0], target_chunk):
            tc = t[t0 : t0 + target_chunk]
            d = q_sq[:, None] + t_sq[None, t0 : t0 + target_chunk] - 2.0 * (qc @ tc.T)
            cd, ci = torch.topk(d, k, dim=1, largest=False, sorted=True)
            md = torch.cat([best_d, cd], dim=1)
            mi = torch.cat([best_i, ci + t0], dim=1)
            best_d, pos = torch.topk(md, k, dim=1, largest=False, sorted=True)
            best_i = torch.gather(mi, 1, pos)
        idx_out.append(best_i)
    idx = torch.cat(idx_out) if idx_out else query.new_zeros((0, k), dtype=torch.int64)
    diff = query[:, None, :] - t[idx]
    sqd = torch.sum(diff * diff, dim=-1)
    order = torch.argsort(sqd, dim=1, stable=True)
    return (
        torch.gather(idx, 1, order).to(torch.int32),
        torch.gather(sqd, 1, order),
    )

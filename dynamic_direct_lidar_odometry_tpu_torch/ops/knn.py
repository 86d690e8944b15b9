"""Exact brute-force nearest-neighbor sweeps (counterpart of ``ops/knn.py``).

Candidate selection expands ``||q||^2 + ||t||^2 - 2 q.t`` chunk by chunk
(the cross term a full-f32 matmul: TF32 is off package-wide) with a
running min / top-k merge, then the returned squared distances are
recomputed exactly as ``||q - t[idx]||^2``. These are the CPU path of
every NN call and the oracle for the CUDA kernels.

Dispatch follows the JAX package: on the accelerator (CUDA tensors)
``nn1_best`` takes the dense 1-NN kernel and ``knn_best`` the lane-class
k-NN kernel (``ops/nn_cuda.py``), as the JAX package takes its Pallas
kernels on the TPU; on the CPU both take the exact sweeps below.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

_BIG = 3.0e12


def nn1_best(query: torch.Tensor, target: torch.Tensor):
    """1-NN: the dense kernel (``nn_cuda.nn1_dense``, the JAX package's
    ``nn1_pallas``) on the accelerator, the exact sweep on the CPU."""
    if device.on_accelerator(query):
        return nn_cuda.nn1_dense(query, target)
    return nn1(query, target)


def knn_best(query: torch.Tensor, target: torch.Tensor, k: int):
    """k-NN for covariance neighborhoods: on the accelerator the lane-class
    kernel (``nn_cuda.knn_approx``, the JAX package's
    ``knn_approx_pallas``) unless ``DDLO_KNN_IMPL=exact`` or k > 128;
    otherwise, and on the CPU, the exact sweep."""
    if (
        device.on_accelerator(query)
        and k <= 128
        and os.environ.get("DDLO_KNN_IMPL", "auto") != "exact"
    ):
        return nn_cuda.knn_approx(query, target, k)
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

"""Exact brute-force nearest-neighbor sweeps (counterpart of ``ops/knn.py``).

Candidate selection expands ``||q||^2 + ||t||^2 - 2 q.t`` chunk by chunk
(the cross term a full-f32 matmul: TF32 is off package-wide) with a
running min / top-k merge, then the returned squared distances are
recomputed exactly as ``||q - t[idx]||^2``. These are the CPU path of
every NN call and the oracle for the CUDA kernels. On the host both the
selection and the returned distances round as the JAX package's jitted
sweeps do on the CPU (:func:`_select`), so a near-tie goes the same way.

Dispatch follows the JAX package: on the accelerator (CUDA tensors)
``nn1_best`` takes the dense 1-NN kernel and ``knn_best`` the lane-class
k-NN kernel (``ops/nn_cuda.py``), as the JAX package takes its Pallas
kernels on the TPU; on the CPU both take the exact sweeps below.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device, fp
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL, pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

_BIG = 3.0e12
_DENORM_MAX = 2.0**-126 - 2.0**-149  # the largest f32 denormal
_SLACK = 8  # host candidates beyond k, ranked in XLA's rounding
_MARGIN = 2.0**-18  # bound on |plain - XLA| distance / (||q||^2 + d)
_REDO_ROWS = 64  # rows ranked over every target at once


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


def _f32(x: torch.Tensor) -> torch.Tensor:
    """To f32 (one rounding from f64), denormals flushed as XLA's CPU code
    flushes them."""
    return torch.nn.functional.hardshrink(x.float(), _DENORM_MAX)


def _sumsq(v: torch.Tensor, xla: bool) -> torch.Tensor:
    """sum over the last axis (3) of ``v * v``; with ``xla`` as XLA's CPU
    loop rounds it, ``fma(z, z, fma(y, y, x * x))``, denormals flushed."""
    if not xla:
        return torch.sum(v * v, dim=-1)
    v = v.double()
    acc = _f32(v[..., 0] * v[..., 0])
    for c in (1, 2):
        acc = _f32(fp.fma32(v[..., c], v[..., c], acc))
    return acc


def _xla_sqdist(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``||q||^2 + ||t||^2 - 2 q.t`` for broadcast (..., 3) rows as the JAX
    sweeps' jitted code rounds it on the CPU: the norms and the K = 3 dot
    as FMA chains (``fma(q2, t2, fma(q1, t1, q0 t0))``), then
    ``(q_sq + t_sq) - 2 c``."""
    q64, t64 = q.double(), t.double()
    c = _f32(q64[..., 0] * t64[..., 0])
    for i in (1, 2):
        c = _f32(fp.fma32(q64[..., i], t64[..., i], c))
    return (_sumsq(q, True) + _sumsq(t, True)) - 2.0 * c


def _keys(d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 distances and int64 indices -> int64 keys ordered as (distance,
    index): JAX's top_k / argmin order on ties."""
    b = d.contiguous().view(torch.int32)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return (b.long() << 32) | idx


def _key_dist(key: torch.Tensor) -> torch.Tensor:
    """The distance of a :func:`_keys` key."""
    b = (key >> 32).to(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).view(torch.float32)


def _sweep(query, t, m, query_chunk, target_chunk):
    """(d, idx) of the m nearest targets of every query row, ascending, over
    the padded target ``t``: the f32 expansion ``||q||^2 + ||t||^2 - 2 q.t``
    with a full-f32 matmul (TF32 is off package-wide), a running min (m =
    1: strict ``<``, the lower index on ties) or top-m merge per chunk,
    from JAX's (BIG, 0) start."""
    t_sq = torch.sum(t * t, dim=-1)
    d_out, i_out = [], []
    for q0 in range(0, query.shape[0], query_chunk):
        qc = query[q0 : q0 + query_chunk]
        q_sq = torch.sum(qc * qc, dim=-1)
        best_d = torch.full((qc.shape[0], m), _BIG, device=qc.device)
        best_i = torch.zeros((qc.shape[0], m), dtype=torch.int64, device=qc.device)
        for t0 in range(0, t.shape[0], target_chunk):
            tc = t[t0 : t0 + target_chunk]
            d = q_sq[:, None] + t_sq[None, t0 : t0 + target_chunk] - 2.0 * (qc @ tc.T)
            if m == 1:
                ci = torch.argmin(d, dim=1, keepdim=True)
                cd = torch.gather(d, 1, ci)
                take = cd < best_d
                best_d = torch.where(take, cd, best_d)
                best_i = torch.where(take, ci + t0, best_i)
                continue
            cd, ci = torch.topk(d, m, dim=1, largest=False, sorted=True)
            md = torch.cat([best_d, cd], dim=1)
            mi = torch.cat([best_i, ci + t0], dim=1)
            best_d, pos = torch.topk(md, m, dim=1, largest=False, sorted=True)
            best_i = torch.gather(mi, 1, pos)
        d_out.append(best_d)
        i_out.append(best_i)
    if not d_out:
        return query.new_zeros((0, m)), query.new_zeros((0, m), dtype=torch.int64)
    return torch.cat(d_out), torch.cat(i_out)


def _select(query, t, k, query_chunk, target_chunk):
    """(Q, k) indices of the k nearest targets per query row.

    On the card: the card's expansion (:func:`_sweep`). On the host: the
    k smallest (d, index) with d in the JAX sweeps' CPU rounding
    (:func:`_xla_sqdist`), which decides a near-tie of the k-th neighbor.
    Its f64 chains over every pair would cost 8x the matmul, so the host
    sweeps the plain expansion for ``k + _SLACK`` candidates, ranks them
    in XLA's rounding and proves that no other target can enter: the two
    roundings differ by at most ``2^-18 (||q||^2 + d)`` (a few roundings
    each of ||q||^2, ||t||^2 <= 2 ||q||^2 + 2 d and 2 q.t). A SENTINEL
    query needs no proof: in XLA's rounding its distance to every
    SENTINEL target is 0 (the cross term is the norm's chain), far below
    any real target's, so it takes the k lowest SENTINEL rows. Other rows
    where the proof fails are ranked in XLA's rounding over every
    target."""
    if query.device.type != "cpu":
        return _sweep(query, t, k, query_chunk, target_chunk)[1]
    d, cand = _sweep(query, t, k + _SLACK, query_chunk, target_chunk)
    dx = _xla_sqdist(query[:, None, :], t[cand])
    ranked = torch.topk(_keys(dx, cand), k, dim=1, largest=False, sorted=True).values
    sel = ranked & 0xFFFFFFFF
    q_sq = torch.sum(query.double() ** 2, dim=-1)
    bound = d[:, -1].double()
    proved = bound - _MARGIN * (q_sq + bound.abs()) > _key_dist(ranked[:, -1]).double()
    sentinel = (query == SENTINEL).all(1)
    lowest = torch.nonzero((t == SENTINEL).all(1))[:k, 0]
    if len(lowest) == k:
        sel = torch.where(sentinel[:, None], lowest, sel)
    else:
        sentinel = torch.zeros_like(sentinel)
    redo = torch.nonzero(~(proved | sentinel))[:, 0]
    for r0 in range(0, len(redo), _REDO_ROWS):
        rows = redo[r0 : r0 + _REDO_ROWS]
        sel[rows] = _select_xla(query[rows], t, k, target_chunk)
    return sel


def _select_xla(query, t, k, target_chunk):
    """:func:`_select` for a few rows, in XLA's rounding over every target."""
    best = None
    for t0 in range(0, t.shape[0], target_chunk):
        d = _xla_sqdist(query[:, None, :], t[None, t0 : t0 + target_chunk])
        ck = _keys(d, torch.arange(t0, t0 + d.shape[1], device=d.device).expand_as(d))
        best = ck if best is None else torch.cat([best, ck], dim=1)
        best = torch.topk(best, k, dim=1, largest=False, sorted=True).values
    return best & 0xFFFFFFFF


def nn1(
    query: torch.Tensor,
    target: torch.Tensor,
    query_chunk: int = 1024,
    target_chunk: int = 8192,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force 1-NN: (idx (Q,) int32, sqdist (Q,) f32) of the nearest
    target row per query row, ties to the lower index. Invalid rows must
    sit at the SENTINEL; a sentinel query may get an index into the 1e6
    target padding (>= T), as in the JAX package, whose gathers clamp it
    (callers clamp too). On the host the selection and the distance round
    as the JAX package's jitted sweep on the CPU."""
    t = pad_rows(target, target_chunk, 1.0e6)
    idx = _select(query, t, 1, query_chunk, target_chunk)[:, 0]
    return idx.to(torch.int32), _sumsq(query - t[idx], query.device.type == "cpu")


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
    the exactly recomputed distance (stable on ties). On the host the
    selection and the distances round as the JAX package's jitted sweep
    on the CPU."""
    t = pad_rows(target, target_chunk, 1.0e6)
    idx = _select(query, t, k, query_chunk, target_chunk)
    sqd = _sumsq(query[:, None, :] - t[idx], query.device.type == "cpu")
    order = torch.argsort(sqd, dim=1, stable=True)
    return (
        torch.gather(idx, 1, order).to(torch.int32),
        torch.gather(sqd, 1, order),
    )

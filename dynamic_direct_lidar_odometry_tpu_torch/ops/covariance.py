"""Per-point GICP covariances with PLANE regularization (counterpart of
``ops/covariance.py``): the exact k-NN path, the Morton-block window
path, and the closed-form smallest-eigenvector regularization."""

from __future__ import annotations

import math
import os

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn as knn_ops


def plane_covariances(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int = 20,
    neighbor_points: torch.Tensor | None = None,
    morton_ordered: bool = False,
) -> torch.Tensor:
    """Regularized (N, 3, 3) covariances for a masked cloud; invalid
    points get identity.

    ``morton_ordered``: the caller promises the rows are Morton sorted
    (a ``filters.voxel_downsample`` output). On CUDA that selects the
    window path, as on the JAX package's TPU; on CPU the exact k-NN
    path runs, as on the JAX package's CPU.
    """
    tgt = points if neighbor_points is None else neighbor_points
    impl = os.environ.get("DDLO_KNN_IMPL", "auto")
    if (
        neighbor_points is None
        and morton_ordered
        and device.on_accelerator(points)
        and impl in ("auto", "window")
    ):
        cov = _window_self_covariances(points, k)
    else:
        idx, _ = knn_ops.knn_best(points, tgt, k)
        # clamp like a JAX gather: a sentinel query's neighbors may be
        # padded target rows (its covariance is masked to identity)
        neigh = tgt[idx.long().clamp_max(tgt.shape[0] - 1)]  # (N, k, 3)
        cov = neighborhood_covariance(neigh)

    cov_reg = regularize_plane(cov)
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.where(mask[:, None, None], cov_reg, eye)


def neighborhood_covariance(neigh: torch.Tensor) -> torch.Tensor:
    """``X^T X / k`` of each (k, 3) neighborhood centered on its mean (the
    reference's normalization), rounded in the order the JAX package's
    jitted CPU code takes: the mean as a sequential sum over k times the
    f32 ``1/k`` (XLA turns a division by a constant into that product),
    the covariance as k sequential fused multiply-adds of the outer
    products, then times ``1/k``. A product of two f32 is exact in f64,
    so each multiply-add is the f64 product plus the accumulator, rounded
    to f32."""
    k = neigh.shape[1]
    s = neigh[:, 0]
    for j in range(1, k):
        s = s + neigh[:, j]
    centered = (neigh - (s * (1.0 / k))[:, None, :]).double()
    acc = torch.zeros(neigh.shape[0], 3, 3, dtype=torch.float32, device=neigh.device)
    for j in range(k):
        c = centered[:, j]
        acc = torch.addcmul(acc.double(), c[:, :, None], c[:, None, :]).float()
    return acc * (1.0 / k)


def _window_self_covariances(
    points: torch.Tensor, k: int, block: int = 128
) -> torch.Tensor:
    """Self-neighborhood covariances over a MORTON-BLOCK candidate set:
    each query takes its k nearest among the rows of its 128-row block
    and the two adjacent blocks (rolled, so the first and last blocks
    wrap), with every ``d2 <= k-th smallest`` candidate weighted in (ties
    may push the count past k; normalized by the actual count). All
    block-centered so the f32 ``E[yy] - mm`` never cancels against
    ``|x|^2``-sized terms."""
    N = points.shape[0]
    B = block
    pad = (-N) % B
    p = points
    if pad:
        p = torch.cat([p, p.new_full((pad, 3), 3.0e12)])
    nb = p.shape[0] // B
    q = p.reshape(nb, B, 3)
    ctr = q[:, 0, :]
    yq = q - ctr[:, None, :]
    c = torch.cat([torch.roll(q, 1, dims=0), q, torch.roll(q, -1, dims=0)], dim=1)
    yc = c - ctr[:, None, :]  # (nb, 3B, 3)
    qq = torch.sum(yq * yq, dim=-1)  # (nb, B)
    cc = torch.sum(yc * yc, dim=-1)  # (nb, 3B)
    cross = torch.matmul(yq, yc.transpose(1, 2))  # (nb, B, 3B)
    d2 = qq[:, :, None] + cc[:, None, :] - 2.0 * cross
    rk = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values[..., k - 1]
    w = (d2 <= rk[..., None]).to(points.dtype)
    cnt = torch.clamp_min(torch.sum(w, dim=-1), 1.0)  # (nb, B)
    sum_y = torch.matmul(w, yc)  # (nb, B, 3)
    yy = (yc[:, :, :, None] * yc[:, :, None, :]).reshape(nb, 3 * B, 9)
    sum_yy = torch.matmul(w, yy).reshape(nb, B, 3, 3)
    mean_y = sum_y / cnt[..., None]
    cov = sum_yy / cnt[..., None, None] - (
        mean_y[..., :, None] * mean_y[..., None, :]
    )
    return cov.reshape(nb * B, 3, 3)[:N]


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    by the closed form (Cardano eigenvalue + largest cross product of the
    rows of ``A - lmin I``); near-isotropic matrices fall back to e_z.
    Divisions by a constant are products with its f32 reciprocal, as XLA
    rewrites them in the JAX package."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    q = (a00 + a11 + a22) * (1.0 / 3.0)
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    ) * (1.0 / 6.0)
    p = torch.sqrt(torch.clamp_min(p2, 1e-30))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) * (1.0 / 3.0)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    c00, c11, c22 = a00 - lmin, a11 - lmin, a22 - lmin
    r0 = torch.stack([c00, a01, a02], dim=-1)
    r1 = torch.stack([a01, c11, a12], dim=-1)
    r2 = torch.stack([a02, a12, c22], dim=-1)
    c01 = torch.linalg.cross(r0, r1, dim=-1)
    c02 = torch.linalg.cross(r0, r2, dim=-1)
    c12 = torch.linalg.cross(r1, r2, dim=-1)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nrm = torch.linalg.vector_norm(best, dim=-1, keepdim=True)
    ez = torch.zeros_like(best)
    ez[..., 2] = 1.0
    return torch.where(nrm > 1e-12, best / torch.clamp_min(nrm, 1e-30), ez)


def regularize_plane(cov: torch.Tensor) -> torch.Tensor:
    """Spectrum-replace each covariance with (1, 1, 1e-3):
    ``I - (1 - 1e-3) n n^T`` with n the surface normal."""
    n = smallest_eigvec_sym3(cov)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return eye - (1.0 - 1e-3) * n[..., :, None] * n[..., None, :]

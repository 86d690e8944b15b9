"""SO(3)/SE(3) primitives (counterpart of ``core/se3.py``).

Same formulas, same [w, x, y, z] quaternion convention and the same
Taylor guards near theta = 0. Batched over leading dims.
"""

from __future__ import annotations

import math

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device as device_mod
from dynamic_direct_lidar_odometry_tpu_torch.core import fp

_EPS = 1e-12


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp_quat(omega: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> unit quaternion [w, x, y, z]."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta_sq, _EPS))
    half = 0.5 * theta
    small = theta_sq < 1e-10
    imag_big = torch.sin(half) / torch.where(small, 1.0, theta)
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, 1.0 - (1.0 / 8.0) * theta_sq, torch.cos(half))
    return torch.cat([real[..., None], imag[..., None] * omega], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w,x,y,z] (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion [w,x,y,z] by the
    branch-free Shepperd's method of the JAX package, rounded as its jitted
    CPU code: roots and quotients correctly rounded (through f64), the
    norm's sum of squares an FMA chain."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS).double()).float()

    def _div(a, b):
        return (a.double() / b.double()).float()

    s0 = _safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack(
        [0.25 * s0, _div(m21 - m12, s0), _div(m02 - m20, s0), _div(m10 - m01, s0)], dim=-1
    )
    s1 = _safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack(
        [_div(m21 - m12, s1), 0.25 * s1, _div(m01 + m10, s1), _div(m02 + m20, s1)], dim=-1
    )
    s2 = _safe_sqrt(1.0 - m00 + m11 - m22) * 2.0
    q2 = torch.stack(
        [_div(m02 - m20, s2), _div(m01 + m10, s2), 0.25 * s2, _div(m12 + m21, s2)], dim=-1
    )
    s3 = _safe_sqrt(1.0 - m00 - m11 + m22) * 2.0
    q3 = torch.stack(
        [_div(m10 - m01, s3), _div(m02 + m20, s3), _div(m12 + m21, s3), 0.25 * s3], dim=-1
    )

    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    scores = torch.stack(
        [tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1
    )
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(
        cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2
    )[..., 0, :]
    q64 = q.double()
    sq = (q64[..., 0] * q64[..., 0]).float()
    for c in (1, 2, 3):
        sq = fp.fma32(q64[..., c], q64[..., c], sq)
    return _div(q, torch.sqrt(sq.double()).float()[..., None])


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of [w,x,y,z] quaternions."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_angle_deg(q: torch.Tensor) -> torch.Tensor:
    """Rotation angle in degrees of a unit quaternion, 2 atan2(|xyz|, w)."""
    xyz = torch.linalg.vector_norm(q[..., 1:], dim=-1)
    return 2.0 * torch.atan2(xyz, q[..., 0]) * (180.0 / math.pi)


def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)
    return T


def se3_exp(d: torch.Tensor) -> torch.Tensor:
    """Twist [omega(3), t(3)] -> 4x4 transform with R=exp(omega), trans=t.

    The translation is used directly, NOT passed through the SE(3)
    V-matrix: the reference optimizer's update convention."""
    return from_rt(quat_to_matrix(so3_exp_quat(d[..., :3])), d[..., 3:])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply 4x4 transform (..., 4, 4) to points (..., N, 3).

    Rounds as the jitted JAX package does on the CPU, on every device:
    XLA contracts the sum into ``fma(z, R2, fma(x, R0, y R1)) + t``, each
    FMA rounded once (``fp.fma32``). (GICP's loops on the card take a
    plain elementwise form: ``gicp.TORCH``.)"""
    f = torch.float64
    p, R = pts.to(f), T[..., :3, :3].to(f)
    s = (p[..., 1:2] * R[..., None, :, 1]).float()
    s = fp.fma32(p[..., 0:1], R[..., None, :, 0], s)
    s = fp.fma32(p[..., 2:3], R[..., None, :, 2], s)
    return s + T[..., None, :3, 3]


def identity(dtype=torch.float32, *, device="cuda") -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device_mod.resolve(device))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """4x4 pose composition at full f32 (TF32 is off package-wide)."""
    return torch.matmul(A, B)

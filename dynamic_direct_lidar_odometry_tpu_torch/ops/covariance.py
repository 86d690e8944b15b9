"""Per-point GICP covariances with PLANE regularization (counterpart of
``ops/covariance.py``): the exact k-NN path, the Morton-block window
path, and the closed-form smallest-eigenvector regularization.

Two hand-written kernels, both in ``csrc/plane_reg.cu``, each with its
plain version here: on the card the window path is one
``ddlo_window_plane_cov`` launch (:func:`window_plane_covariances`;
plain :func:`window_plane_covariances_plain`), and the exact path's
regularization one ``ddlo_plane_reg`` launch (:func:`regularize_plane`;
plain :func:`regularize_plane_plain`)."""

from __future__ import annotations

import math
import os

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import device, fp
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn as knn_ops
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


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
    window path, as on the JAX package's TPU: :func:`window_plane_covariances`,
    one ``csrc/plane_reg.cu`` launch for the window, the selection, the
    moments, the regularization and the mask. Otherwise (on CPU, as on
    the JAX package's CPU; ``neighbor_points``; ``DDLO_KNN_IMPL=exact``
    or ``pallas``) the exact k-NN path runs: ``knn_best``, the
    neighborhoods' covariances, then :func:`regularize_plane`.
    """
    profiling.count(points.device, "covariance_calls")  # on the device: a replay counts
    tgt = points if neighbor_points is None else neighbor_points
    impl = os.environ.get("DDLO_KNN_IMPL", "auto")
    if (
        neighbor_points is None
        and morton_ordered
        and device.on_accelerator(points)
        and impl in ("auto", "window")
    ):
        return window_plane_covariances(points, mask, k)
    idx, _ = knn_ops.knn_best(points, tgt, k)
    # clamp like a JAX gather: a sentinel query's neighbors may be
    # padded target rows (its covariance is masked to identity)
    neigh = tgt[idx.long().clamp_max(tgt.shape[0] - 1)]  # (N, k, 3)
    cov_reg = regularize_plane(neighborhood_covariance(neigh))
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.where(mask[:, None, None], cov_reg, eye)


def neighborhood_covariance(neigh: torch.Tensor) -> torch.Tensor:
    """``X^T X / k`` of each (k, 3) neighborhood centered on its mean (the
    reference's normalization), rounded in the order the JAX package's
    jitted CPU code takes: the mean as a sequential sum over k times the
    f32 ``1/k`` (XLA turns a division by a constant into that product),
    the covariance as k sequential fused multiply-adds of the outer
    products (``fp.fma32``), then times ``1/k``."""
    k = neigh.shape[1]
    s = neigh[:, 0]
    for j in range(1, k):
        s = s + neigh[:, j]
    centered = neigh - (s * (1.0 / k))[:, None, :]
    acc = torch.zeros(neigh.shape[0], 3, 3, dtype=torch.float32, device=neigh.device)
    for j in range(k):
        c = centered[:, j]
        acc = fp.fma32(c[:, :, None], c[:, None, :], acc)
    return acc * (1.0 / k)


WINDOW_BLOCK = 128  # the window path's Morton block
_PAD = 3.0e12  # the rows past N


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a . b`` over a last axis of 3 as XLA's CPU loop rounds it (the
    JAX package's ``jnp.sum(y * y, -1)`` and HIGHEST ``einsum``):
    ``fma(a2, b2, fma(a1, b1, a0 b0))``."""
    return fp.fma32(a[..., 2], b[..., 2], fp.fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _window_d2(points: torch.Tensor, block: int = WINDOW_BLOCK) -> tuple:
    """The window's anchored candidates ``yc`` (nb, 3B, 3) and their
    squared distances to the queries ``d2`` (nb, B, 3B), rounded as
    :func:`_window_self_covariances` says."""
    N, B = points.shape[0], block
    pad = (-N) % B
    p = points
    if pad:
        p = torch.cat([p, p.new_full((pad, 3), _PAD)])
    q = p.reshape(p.shape[0] // B, B, 3)
    c = torch.cat([torch.roll(q, 1, dims=0), q, torch.roll(q, -1, dims=0)], dim=1)
    yc = c - q[:, :1, :]  # anchored at each block's row 0
    cc = _dot3(yc, yc)  # (nb, 3B)
    yq, qq = yc[:, B:2 * B, None, :], cc[:, B:2 * B, None]
    cross = _dot3(yq, yc[:, None])
    return yc, (qq + cc[:, None, :]) - 2.0 * cross


def _window_self_covariances(
    points: torch.Tensor, k: int, block: int = WINDOW_BLOCK
) -> torch.Tensor:
    """Self-neighborhood covariances over a MORTON-BLOCK candidate set:
    each query takes its k nearest among the rows of its 128-row block
    and the two adjacent blocks (rolled, so the first and last blocks
    wrap), with every ``d2 <= k-th smallest`` candidate weighted in (ties
    may push the count past k; normalized by the actual count). All
    block-centered so the f32 ``E[yy] - mm`` never cancels against
    ``|x|^2``-sized terms.

    Rounded as the JAX package's jitted function rounds on the CPU (XLA,
    read from its outputs), one eager operation each, so that
    ``csrc/plane_reg.cu`` ``window_cov_kernel`` can follow it: ``y = p -
    anchor``; ``|y|^2`` and ``yq . yc`` as XLA's loops (:func:`_dot3`);
    ``d2 = (|yq|^2 + |yc|^2) - 2 yq . yc``; the k-th smallest ``rk`` by
    ``torch.topk`` (exact); then the count and the sums of ``y`` and ``y
    y^T`` over the selected candidates as XLA's dot takes them: 4
    accumulators by candidate index mod 4, each adding its selected
    candidates in ascending order from +0 (an unselected one is skipped),
    then ``(a0 + a1) + (a2 + a3)``; finally ``mean = sum_y / cnt`` and
    ``fma(-mean_a, mean_b, sum_ab / cnt)``, divided by f32 tensors."""
    N, B = points.shape[0], block
    yc, d2 = _window_d2(points, B)
    nb = yc.shape[0]
    rk = torch.topk(d2, k, dim=-1, largest=False, sorted=True).values[..., k - 1:k]
    sel = (d2 <= rk).reshape(nb, B, 3 * B // 4, 4, 1)
    cnt = torch.clamp_min(sel.sum(dim=(2, 3, 4)).to(points.dtype), 1.0)  # (nb, B), exact
    y0, y1, y2 = yc.unbind(-1)
    terms = torch.stack([y0, y1, y2, y0 * y0, y0 * y1, y0 * y2, y1 * y1, y1 * y2, y2 * y2], -1)
    terms = terms.reshape(nb, 1, 3 * B // 4, 4, 9)
    acc = torch.zeros(nb, B, 4, 9, dtype=points.dtype, device=points.device)
    for u in range(3 * B // 4):
        acc = torch.where(sel[:, :, u], acc + terms[:, :, u], acc)
    s = (acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])  # (nb, B, 9)
    mean = s[..., :3] / cnt[..., None]
    s00, s01, s02, s11, s12, s22 = s[..., 3:].unbind(-1)
    syy = torch.stack([s00, s01, s02, s01, s11, s12, s02, s12, s22], -1).reshape(nb, B, 3, 3)
    cov = fp.fma32(-mean[..., :, None], mean[..., None, :], syy / cnt[..., None, None])
    return cov.reshape(nb * B, 3, 3)[:N]


def window_plane_covariances(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """``plane_covariances``' window path: the Morton-window covariances
    of :func:`_window_self_covariances`, regularized, identity on masked
    rows. A CUDA tensor launches ``csrc/plane_reg.cu``
    ``ddlo_window_plane_cov`` (one launch, counted in
    ``nn_cuda.LAUNCHES["window_plane_cov"]``) or raises; a CPU tensor runs
    :func:`window_plane_covariances_plain`, the kernel's plain version;
    any other device raises. Both give the same bits."""
    if points.is_cuda:
        return _window_plane_cov_cuda(points, mask, k)
    if points.device.type != "cpu":
        raise ValueError(f"window_plane_covariances: no kernel for a tensor on {points.device}")
    return window_plane_covariances_plain(points, mask, k)


def _window_plane_cov_cuda(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    n = points.shape[0]
    if (points.dtype != torch.float32 or points.dim() != 2 or points.shape[1] != 3
            or mask.dtype != torch.bool or tuple(mask.shape) != (n,) or mask.device != points.device):
        raise ValueError(
            f"window_plane_covariances: expected (N, 3) float32 points and an (N,) bool mask on one "
            f"device, got {points.dtype} {tuple(points.shape)} and {mask.dtype} {tuple(mask.shape)} "
            f"on {mask.device}"
        )
    if not 1 <= k <= 3 * WINDOW_BLOCK:
        raise ValueError(f"window_plane_covariances: k = {k} outside 1..{3 * WINDOW_BLOCK}")
    out = torch.empty((n, 3, 3), dtype=torch.float32, device=points.device)
    if n:
        lib = nn_cuda.build()["plane_reg"].lib
        nn_cuda.run_kernel(lib.ddlo_window_plane_cov, "window_plane_cov",
                           points.contiguous(), mask.contiguous(), n, k, out)
    return out


def window_plane_covariances_plain(points: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """The window kernel's plain version: :func:`_window_self_covariances`,
    :func:`regularize_plane_plain`, identity on masked rows."""
    cov = regularize_plane_plain(_window_self_covariances(points, k))
    eye = torch.eye(3, dtype=points.dtype, device=points.device)
    return torch.where(mask[:, None, None], cov, eye)


# Every function below rounds as the JAX package's jitted
# ``regularize_plane`` does on the CPU (XLA, x86-64 with FMA, glibc 2.36);
# ``csrc/plane_reg.cu`` is the same chain, operation for operation.
# - XLA's CPU code generator contracts a multiply feeding an add or a
#   subtract into one fused multiply-add, taking the product that is the
#   first operand in its fusion's LLVM IR; each contraction is written out
#   as ``_fma``, one correctly rounded multiply-add (``fp.fma32``).
# - XLA runs with denormals flushed to zero, on input and on output:
#   ``_ftz`` follows every f32 operation of the chain.
# - Roots and quotients are taken in f64 and rounded once, which is
#   correctly rounded in f32 (53 >= 2 * 24 + 2), as XLA's are; torch's f32
#   CPU root was measured 0.74 ulp off on one host.
# - XLA calls the C library for ``cos`` and ``atan2`` (its ``arccos`` is
#   ``atan2(sqrt((1 - x)(1 + x)), x)``); ``_cosf`` and ``_atan2f`` copy
#   glibc's algorithms.
# Every step is its own eager op, so no fused kernel on the card contracts
# or reorders anything, and the plain version on the card gives the host's
# bits.

_DENORM_MAX = 2.0**-126 - 2.0**-149  # the largest f32 denormal


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush f32 denormals to zero (one op)."""
    return torch.nn.functional.hardshrink(x, _DENORM_MAX)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding, flushed."""
    return _ftz(fp.fma32(a, b, c))


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    return _ftz(a * b)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x.double()).float()


def _div_rn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _ftz((a.double() / b.double()).float())


# glibc's sincosf tables (sysdeps/ieee754/flt-32/sincosf_data.c)
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")
_COS_C = [float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SIN_S = [float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13")]


def _cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's ``cosf`` for pi/4 <= |y| < 120 (the range reduction and the
    two polynomials are evaluated in f64, then rounded once)."""
    x = y.double()
    n = ((x * _HPI_INV).to(torch.int32) + 0x800000) >> 24
    x = x - n.double() * _HPI
    use_cos = (n & 1) == 0  # cos in an odd quadrant is the sine polynomial
    s = torch.where(((n + 1) & 2) == 0, 1.0, -1.0).double()  # sign[n & 3]
    flip = torch.where((n & 2) != 0, -1.0, 1.0).double()
    x2 = x * x
    xs = x * s
    x3 = xs * x2
    sin_r = (xs + x3 * _SIN_S[0]) + (x3 * x2) * (_SIN_S[1] + x2 * _SIN_S[2])
    c0, c1, c2, c3, c4 = (flip * c for c in _COS_C)
    x4 = x2 * x2
    cos_r = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    return torch.where(use_cos, cos_r, sin_r).float()


# glibc's fdlibm ``atanf`` (sysdeps/ieee754/flt-32/s_atanf.c), in f32
_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)


_PI, _PI_LO, _PI_O_2 = 3.1415927410e+00, -8.7422776573e-08, 1.5707963705e+00
# every f32 constant of the chain, uploaded once per call; 0-d views of it
# keep each operation f32 with f32 operands (a Python number would not:
# ``c / x`` on a tensor is ``reciprocal(x) * c``)
_CONSTS = (1.0, 2.0, 1.5, 0.5, 1.0 / 3.0, 1.0 / 6.0, 2.0 * math.pi / 3.0, 1.0 - 1e-3,
           _PI, _PI_LO, _PI_O_2) + _AT + _ATANHI + _ATANLO


class _K:
    """0-d f32 views of :data:`_CONSTS` on one device."""

    def __init__(self, device):
        self.t = torch.tensor(_CONSTS, dtype=torch.float32, device=device)
        (self.one, self.two, self.one_half, self.half, self.third, self.sixth,
         self.two_pi_3, self.plane, self.pi, self.pi_lo, self.pi_o_2) = self.t[:11]
        self.at = self.t[11:22]
        self.hi, self.lo = self.t[22:26], self.t[26:30]


def _atanf(x: torch.Tensor, k: _K) -> torch.Tensor:
    """glibc's ``atanf`` for x >= 0, every operation rounded to f32."""
    one = k.one
    bits = x.view(torch.int32)
    idx = ((bits >= 0x3EE00000).int() + (bits >= 0x3F300000).int()
           + (bits >= 0x3F980000).int() + (bits >= 0x401C0000).int()) - 1
    red = torch.where(idx == 0, (k.two * x - one) / (k.two + x), x)
    red = torch.where(idx == 1, (x - one) / (x + one), red)
    red = torch.where(idx == 2, (x - k.one_half) / (one + k.one_half * x), red)
    red = torch.where(idx == 3, -one / x, red)
    at = k.at
    z = red * red
    w = z * z
    s1 = z * (at[0] + w * (at[2] + w * (at[4] + w * (at[6] + w * (at[8] + w * at[10])))))
    s2 = w * (at[1] + w * (at[3] + w * (at[5] + w * (at[7] + w * at[9]))))
    tail = red * (s1 + s2)
    hi, lo = k.hi, k.lo
    i = idx.clamp_min(0).long()
    out = torch.where(idx < 0, red - tail, hi[i] - ((tail - lo[i]) - red))
    return torch.where(bits >= 0x4C000000, hi[3] + lo[3], out)


def _atan2f(y: torch.Tensor, x: torch.Tensor, k: _K | None = None) -> torch.Tensor:
    """glibc's ``atan2f`` (sysdeps/ieee754/flt-32/e_atan2f.c) for y >= 0."""
    k = k if k is not None else _K(x.device)
    pi, pi_lo, pi_o_2 = k.pi, k.pi_lo, k.pi_o_2
    ix = x.view(torch.int32) & 0x7FFFFFFF
    iy = y.view(torch.int32) & 0x7FFFFFFF
    e = (iy - ix) >> 23
    neg = torch.signbit(x)
    z = _atanf(torch.abs(y / x), k)
    z = torch.where(e > 60, pi_o_2 + k.half * pi_lo, z)
    z = torch.where(neg & (e < -60), 0.0, z)
    out = torch.where(neg, pi - (z - pi_lo), z)
    out = torch.where(x == 1.0, _atanf(y, k), out)
    out = torch.where(iy == 0, torch.where(neg, pi, y), out)
    out = torch.where(ix == 0, pi_o_2, out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def _sumsq(v: torch.Tensor) -> torch.Tensor:
    """XLA's ``sum(v * v, -1)`` over 3 lanes: a chain of multiply-adds."""
    return _fma(v[..., 2], v[..., 2], _fma(v[..., 1], v[..., 1], _mul(v[..., 0], v[..., 0])))


def _cross(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``jnp.cross(u, v)`` with each lane's first product contracted."""
    i, j = [1, 2, 0], [2, 0, 1]
    return _fma(u[..., i], v[..., j], -_mul(u[..., j], v[..., i]))


def smallest_eigvec_sym3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric (..., 3, 3)
    by the closed form (Cardano eigenvalue + largest cross product of the
    rows of ``A - lmin I``); near-isotropic matrices fall back to e_z.
    Rounded as XLA's CPU fusions round it (see ``_fma``): a division by a
    constant is a product with its f32 reciprocal, and each of the three
    cross products recomputes ``lmin`` in a fusion of its own, ``c01``'s
    with the other product of its sum contracted. Independent chains run
    stacked, one operation for all of them."""
    return _smallest_eigvec(A, _K(A.device))


def _smallest_eigvec(A: torch.Tensor, k: _K) -> torch.Tensor:
    A = _ftz(A)
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    s = _ftz(_ftz(a00 + a11) + a22)
    q = _mul(s, k.third)
    b00, b11, b22 = _ftz(torch.stack([a00, a11, a22], -1) - q[..., None]).unbind(-1)
    # sum of the squared diagonal, and of the squared off-diagonal
    sq = _sumsq(torch.stack([torch.stack([b11, b00, b22], -1), torch.stack([a02, a01, a12], -1)], -2))
    p = _sqrt_rn(torch.clamp_min(_mul(_ftz(sq[..., 0] + sq[..., 1] * k.two), k.sixth), 1e-30))
    # det(A - q I): the three 2x2 minors, then their sum
    m = _fma(torch.stack([b11, a01, a12], -1), torch.stack([b22, b22, a01], -1),
             -_mul(torch.stack([a12, a12, b11], -1), torch.stack([a12, a02, a02], -1)))
    detB = _fma(a02, m[..., 2], _fma(b00, m[..., 0], -_mul(a01, m[..., 1])))
    r = torch.clamp(_div_rn(detB, _mul(_mul(p * k.two, p), p)), -1.0, 1.0)
    acos = _atan2f(_sqrt_rn(_mul(k.one - r, r + k.one)), r, k)
    cs = _cosf(_fma(acos, k.third, k.two_pi_3))
    p2 = p * k.two

    # lmin of c01's fusion (q's product contracted), and of c02's and c12's
    lmin = _fma(torch.stack([s, cs], -1), torch.stack([k.third.expand_as(s), p2], -1),
                torch.stack([_mul(cs, p2), q], -1))
    c00, c11, c22 = _ftz(torch.stack([a00, a11, a22], -1)[..., None, :] - lmin[..., :, None]).unbind(-1)
    r0 = torch.stack([c00, a01.unsqueeze(-1).expand_as(c00), a02.unsqueeze(-1).expand_as(c00)], -1)
    r1 = torch.stack([a01.unsqueeze(-1).expand_as(c11), c11, a12.unsqueeze(-1).expand_as(c11)], -1)
    r2 = torch.stack([a02, a12, c22[..., 1]], -1)
    # c01 = r0 x r1 at the first lmin; c02 = r0 x r2, c12 = r1 x r2 at the second
    c = _cross(torch.stack([r0[..., 0, :], r0[..., 1, :], r1[..., 1, :]], -2),
               torch.stack([r1[..., 0, :], r2, r2], -2))
    n = _sumsq(c)
    n01, n02, n12 = n.unbind(-1)
    c01, c02, c12 = c.unbind(-2)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nrm = _sqrt_rn(_sumsq(best))[..., None]
    ez = torch.zeros_like(best)
    ez[..., 2].fill_(1.0)
    return torch.where(nrm > 1e-12, _div_rn(best, torch.clamp_min(nrm, 1e-30)), ez)


def regularize_plane(cov: torch.Tensor) -> torch.Tensor:
    """Spectrum-replace each (..., 3, 3) covariance with (1, 1, 1e-3):
    ``I - (1 - 1e-3) n n^T`` with n the surface normal. A CUDA tensor
    launches ``csrc/plane_reg.cu`` (one launch, one thread per matrix,
    counted in ``nn_cuda.LAUNCHES["regularize_plane"]``) or raises; a CPU
    tensor runs :func:`regularize_plane_plain`, the kernel's plain
    version; any other device raises. Both give the same bits."""
    if cov.is_cuda:
        return _regularize_plane_cuda(cov)
    if cov.device.type != "cpu":
        raise ValueError(f"regularize_plane: no kernel for a tensor on {cov.device}")
    return regularize_plane_plain(cov)


def _regularize_plane_cuda(cov: torch.Tensor) -> torch.Tensor:
    if cov.dtype != torch.float32 or cov.dim() < 2 or tuple(cov.shape[-2:]) != (3, 3):
        raise ValueError(
            f"regularize_plane: expected (..., 3, 3) float32, got {cov.dtype} {tuple(cov.shape)}"
        )
    flat = cov.reshape(-1, 3, 3).contiguous()
    out = torch.empty_like(flat)
    if flat.shape[0]:
        lib = nn_cuda.build()["plane_reg"].lib
        nn_cuda.run_kernel(lib.ddlo_plane_reg, "regularize_plane", flat, flat.shape[0], out)
    return out.reshape(cov.shape)


def regularize_plane_plain(cov: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version (~700 eager operations): the
    regularization in XLA's CPU bits, the final subtraction contracted as
    XLA contracts it."""
    k = _K(cov.device)
    n = _smallest_eigvec(cov, k)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    return _fma(-_mul(n[..., :, None], k.plane), n[..., None, :], eye)

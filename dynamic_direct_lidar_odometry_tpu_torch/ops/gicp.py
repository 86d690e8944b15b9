"""VGICP-style registration (counterpart of ``ops/gicp.py``).

Same linearization (NN correspondences, Mahalanobis weights
``M = (C_B + R C_A R^T)^-1``, ``H = J^T M J``), same unrolled LDLT solve
and the same Levenberg-Marquardt / Gauss-Newton loops as the JAX
package. Each ``lax.while_loop`` of :func:`align` is a
``core/control.while_loop`` over an LM state held in device tensors and
updated in place, its test a ``control.Test`` (the count under its
bound, the flags): on the card inside a captured graph a WHILE node
decides on the device, the test one kernel launch; outside one the loop
reads only its predicate.
All scalar LM state stays in f32 on the device, so the accept/reject
decisions are the JAX package's arithmetic; :func:`align_batch` runs its
loops the same way, over "any stream still running". The rounding-sensitive steps
(point transform, sums, inverse, compose, and a lambda trial's solve,
exponential and update) come from :func:`arithmetic`: on the host
``ops/gicp_xla.py`` (XLA's CPU order, the jitted JAX package's bits), on
the card :data:`TORCH`, whose whole lambda loop is one launch of
``csrc/lm_trial.cu`` (:func:`lm_inner`) and whose split trial, for a
point-sharded group and the GN step, two (:func:`lm_propose`,
:func:`lm_decide`).

Correspondence backend (``GICPSettings.nn_impl``): "sparse" launches the
CUDA kernel on CUDA tensors (``ops/nn_cuda.py``) with the target-side
preparation hoisted out of the loop; on CPU every impl takes the exact
sweep, as the JAX package does off the TPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import types

import torch

from dynamic_direct_lidar_odometry_tpu_torch.core import control, device, se3
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp_xla
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn as knn_ops
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling


class GICPSettings(NamedTuple):
    """Optimizer settings; fields and defaults as the JAX package's."""

    max_correspondence_distance: float = 1.0
    max_iterations: int = 64
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9
    optimizer: str = "lm"  # "lm" | "gn"
    compute_residuals: bool = True
    record_trace: bool = False
    nn_impl: str = "auto"  # "auto" | "exact" | "pallas" | "sparse"


class GICPResult(NamedTuple):
    T: torch.Tensor  # (4, 4) final transformation
    converged: torch.Tensor  # () bool
    iterations: torch.Tensor  # () int32
    final_error: torch.Tensor  # () f32
    final_hessian: torch.Tensor  # (6, 6)
    num_inliers: torch.Tensor  # () int32
    residuals: torch.Tensor  # (N,)
    correspondences: torch.Tensor  # (N,) int32, -1 if invalid
    # (max_iterations, 4, 4) pose after each outer iteration (rows past
    # `iterations` repeat the final pose); (0, 4, 4) unless record_trace
    pose_trace: Optional[torch.Tensor] = None


def inv3x3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form (adjugate) 3x3 inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d  # noqa: E741
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    adj = torch.stack(
        [
            torch.stack([A, D, G], dim=-1),
            torch.stack([B, E, H], dim=-1),
            torch.stack([C, F, I], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 root, as XLA's (``torch.sqrt`` of an f32
    CPU tensor is not, on some hosts: 13 % of values 1 ulp off on an
    Intel Xeon with torch 2.13)."""
    return torch.sqrt(x.double()).float()


def _sub(v: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return v - p * q


def solve6_ldlt(A: torch.Tensor, b: torch.Tensor, sub=_sub) -> torch.Tensor:
    """Solve the symmetric 6x6 normal equations by the JAX package's
    unrolled LDLT (the reference's Eigen::LDLT), operation for operation,
    so the LM accept/reject decisions match. ``A`` (..., 6, 6), ``b``
    (..., 6): leading dims are independent systems. ``sub(v, p, q)`` is
    every ``v - p q`` of the factorization and the substitutions
    (``gicp_xla.sub``: one FMA, as XLA contracts it on the CPU)."""
    L = [[None] * 6 for _ in range(6)]
    D = [None] * 6
    for j in range(6):
        d = A[..., j, j]
        for k in range(j):
            d = sub(d, L[j][k] * L[j][k], D[k])
        D[j] = torch.where(torch.abs(d) < 1e-30, 1e-30, d)
        for i in range(j + 1, 6):
            v = A[..., i, j]
            for k in range(j):
                v = sub(v, L[i][k] * L[j][k], D[k])
            L[i][j] = v / D[j]
    y = [None] * 6
    for i in range(6):
        v = b[..., i]
        for k in range(i):
            v = sub(v, L[i][k], y[k])
        y[i] = v
    x = [None] * 6
    for i in reversed(range(6)):
        v = y[i] / D[i]
        for k in range(i + 1, 6):
            v = sub(v, L[k][i], x[k])
        x[i] = v
    return torch.stack(x, dim=-1)


def _transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``se3.transform_points`` in plain f32 elementwise muls and adds
    (fewer launches than its f64 FMA form)."""
    R = T[..., :3, :3]
    out = (
        pts[..., 0:1] * R[..., None, :, 0]
        + pts[..., 1:2] * R[..., None, :, 1]
        + pts[..., 2:3] * R[..., None, :, 2]
    )
    return out + T[..., None, :3, 3]


def _linearize_terms(src_t, vf, R, cov_B, src_covs, B):
    """The sums of one linearization after the correspondence search, by
    matrix products (per stream over a leading batch axis): returns
    (M, y0, H, b). ``src_t`` the transformed source, ``vf`` validity as
    0/1, ``R`` the pose's rotation, ``cov_B`` / ``B`` the winners'
    covariances and points."""
    batched = src_t.dim() == 3
    Rn = R[:, None] if batched else R
    RCAR = torch.matmul(torch.matmul(Rn, src_covs), Rn.transpose(-1, -2))
    M = inv3x3(cov_B + RCAR)  # (..., N, 3, 3)

    e = (B - src_t) * vf[..., None]
    Me = torch.matmul(M, e[..., None])[..., 0]
    S = se3.skew(src_t)
    eye = torch.eye(3, dtype=S.dtype, device=S.device).expand_as(S)
    J = torch.cat([S, -eye], dim=-1) * vf[..., None, None]  # (..., N, 3, 6)
    MJ = torch.matmul(M, J)
    N = src_t.shape[-2]
    J2t = J.reshape(*J.shape[:-3], N * 3, 6).transpose(-1, -2)
    MJ2 = MJ.reshape(*J.shape[:-3], N * 3, 6)
    Me2 = Me.reshape(*J.shape[:-3], N * 3)
    if batched:
        # the reductions stream by stream, each the single-stream call on
        # the same shapes, so a stream's sums round as its align's do
        y0 = torch.stack([torch.sum(x) for x in e * Me])
        H = torch.stack([torch.matmul(j, m) for j, m in zip(J2t, MJ2)])
        b = torch.stack([torch.matmul(j, v) for j, v in zip(J2t, Me2)])
    else:
        y0 = torch.sum(e * Me)
        H = torch.matmul(J2t, MJ2)
        b = torch.matmul(J2t, Me2)
    return M, y0, H, b


def _error(src_t, vf, M, B):
    """sum e^T M e with the weights held (per stream over a leading batch
    axis)."""
    e = (B - src_t) * vf[..., None]
    Me = torch.matmul(M, e[..., None])[..., 0]
    if src_t.dim() == 3:
        return torch.stack([torch.sum(x) for x in e * Me])
    return torch.sum(e * Me)


class TrialState(NamedTuple):
    """The carry of the lambda loop, updated in place by each trial (per
    stream over a leading batch axis; ``j`` is one count for all)."""

    lam: torch.Tensor  # f32 damping
    nu: torch.Tensor  # f32 growth factor of a rejected step
    x: torch.Tensor  # (..., 4, 4) pose, the last accepted step's
    delta_done: torch.Tensor  # (..., 4, 4) the step that ended the loop
    done: torch.Tensor  # bool: accepted or converged on a reject
    accepted: torch.Tensor  # bool
    conv: torch.Tensor  # bool: converged on a rejected step
    act: torch.Tensor  # bool: the stream still runs trials
    j: torch.Tensor  # () int32 trials run (:func:`lm_inner`: each stream's, int32)


def _sel(m: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` of a per-stream mask over the trailing dims of a / b."""
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - m.dim())), a, b)


def _se3_exp_card(d: torch.Tensor) -> torch.Tensor:
    """``se3.se3_exp`` with the angle's square summed left to right (the
    kernel's order; ``torch.sum`` on the card picks its own)."""
    om = d[..., :3]
    ts = (om[..., 0] * om[..., 0] + om[..., 1] * om[..., 1]) + om[..., 2] * om[..., 2]
    theta = torch.sqrt(torch.clamp_min(ts, se3._EPS))
    half = 0.5 * theta
    small = ts < 1e-10
    imag = torch.where(small, 0.5 - (1.0 / 48.0) * ts, torch.sin(half) / theta)
    real = torch.where(small, 1.0 - (1.0 / 8.0) * ts, torch.cos(half))
    q = torch.cat([real[..., None], imag[..., None] * om], dim=-1)
    return se3.from_rt(se3.quat_to_matrix(q), d[..., 3:])


def lm_propose_plain(H, b, lam, zero=None, sub=_sub, exp=None):
    """The plain version of ``csrc/lm_trial.cu``'s ``ddlo_lm_propose``:
    ``d = solve6_ldlt(H + lam I, -b)``, zero where ``zero`` (a degenerate
    stream of the GN step), and ``delta = se3_exp(d)``. ``H`` (..., 6, 6),
    ``b`` (..., 6), ``lam`` and ``zero`` (...); returns (d, delta).
    ``sub`` / ``exp``: the solve's ``v - p q`` and the exponential
    (default: the card's, :func:`_se3_exp_card`; ``gicp_xla`` passes
    its own)."""
    eye6 = torch.eye(6, dtype=H.dtype, device=H.device)
    d = solve6_ldlt(H + lam[..., None, None] * eye6, -b, sub)
    if zero is not None:
        d = torch.where(zero[..., None], 0.0, d)
    return d, (_se3_exp_card if exp is None else exp)(d)


def _dot_ltr(d: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``d . g`` over the last axis of six, summed left to right (the
    kernel's order; ``torch.dot`` on the card picks its own)."""
    p = d * g
    dot = p[..., 0]
    for k in range(1, 6):
        dot = dot + p[..., k]
    return dot


def lm_decide_plain(y0, yi, d, b, delta, xi, st: TrialState, s, dot=_dot_ltr):
    """The plain version of ``ddlo_lm_decide``: the rest of a trial once
    the error ``yi`` at ``xi = delta x`` is known (the JAX package's
    lm_inner body), ``st`` updated in place (``s``: the
    :class:`GICPSettings`): accept (rho >= 0), converge on a rejected
    step, or grow lambda; every stream whose ``act`` is false is kept.
    ``dot(d, lam d - b)``: the rho denominator (``gicp_xla`` passes its
    own). Returns the accept and converge-on-reject masks (the kernel's
    wrapper returns nothing)."""
    rho = (y0 - yi) / torch.clamp_min(dot(d, st.lam[..., None] * d - b), 1e-30)
    reject = rho < 0
    acc = st.act & ~reject
    crj = st.act & reject & _is_converged(delta, _conv_eps(s, delta.device))
    grow = st.act & reject & ~crj
    t = 2.0 * rho - 1.0
    st.lam.copy_(torch.where(acc, st.lam * torch.clamp_min(1.0 - t * t * t, 1.0 / 3.0),
                             torch.where(grow, st.nu * st.lam, st.lam)))
    st.nu.copy_(torch.where(grow, 2.0 * st.nu, st.nu))
    st.x.copy_(_sel(acc, xi, st.x))
    st.delta_done.copy_(_sel(acc | crj, delta, st.delta_done))
    st.done.logical_or_(acc | crj)
    st.accepted.logical_or_(acc)
    st.conv.logical_or_(crj)
    st.act.logical_and_(~(acc | crj))
    st.j.add_(1)
    return acc, crj


def _check_card(name, tensors, shapes, dtypes):
    dev = tensors[0].device
    for t, shape, dt in zip(tensors, shapes, dtypes):
        if t is None:
            continue
        if (not t.is_cuda or t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: expected contiguous {dt} {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})"
            )


def lm_propose(H, b, lam, zero=None):
    """:func:`lm_propose_plain` on the card's terms: a CUDA ``H`` launches
    ``csrc/lm_trial.cu``'s ``ddlo_lm_propose`` (one thread per stream,
    counted as ``lm_propose``) or raises; a CPU ``H`` runs the plain
    version; any other device raises. Both give the same bits."""
    if not H.is_cuda:
        if H.device.type != "cpu":
            raise ValueError(f"lm_propose: no kernel for a tensor on {H.device}")
        return lm_propose_plain(H, b, lam, zero)
    lead = tuple(lam.shape)
    H, b = H.contiguous(), b.contiguous()
    _check_card("lm_propose", [H, b, lam, zero], [lead + (6, 6), lead + (6,), lead, lead],
                [torch.float32] * 3 + [torch.bool])
    d = torch.empty(lead + (6,), dtype=torch.float32, device=H.device)
    delta = torch.empty(lead + (4, 4), dtype=torch.float32, device=H.device)
    lib = nn_cuda.build()["lm_trial"].lib
    nn_cuda.run_kernel(lib.ddlo_lm_propose, "lm_propose", H, b, lam, zero, lam.numel(), d, delta)
    return d, delta


def lm_decide(y0, yi, d, b, delta, xi, st: TrialState, s) -> None:
    """:func:`lm_decide_plain` on the card's terms: a CUDA ``y0`` launches
    ``ddlo_lm_decide`` (one thread per stream, ``st`` updated in place,
    counted as ``lm_decide``) or raises; a CPU ``y0`` runs the plain
    version; any other device raises. Both give the same bits."""
    if not y0.is_cuda:
        if y0.device.type != "cpu":
            raise ValueError(f"lm_decide: no kernel for a tensor on {y0.device}")
        lm_decide_plain(y0, yi, d, b, delta, xi, st, s)
        return
    lead = tuple(y0.shape)
    b = b.contiguous()
    f32, flag = torch.float32, torch.bool
    _check_card("lm_decide", [y0, yi, d, b, delta, xi, *st],
                [lead, lead, lead + (6,), lead + (6,)] + [lead + (4, 4)] * 2 + [lead] * 2
                + [lead + (4, 4)] * 2 + [lead] * 4 + [()],
                [f32] * 10 + [flag] * 4 + [torch.int32])
    lib = nn_cuda.build()["lm_trial"].lib
    nn_cuda.run_kernel(lib.ddlo_lm_decide, "lm_decide", y0, yi, d, b, delta, xi, *st, y0.numel(),
                       s.rotation_epsilon, s.transformation_epsilon)  # ctypes rounds them to f32


# lm_inner's error: blocks of a cluster and threads of a block of
# ``csrc/lm_trial.cu``'s ``ddlo_lm_inner`` (its LM_CLUSTER * LM_THREADS
# partial sums fix the order of the sum)
LM_CLUSTER, LM_THREADS = 8, 512


def _compose_ltr(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A @ B`` of 4x4 poses, each entry summed left to right (the
    kernel's order; ``torch.matmul`` on the card picks its own)."""
    out = A[..., :, 0:1] * B[..., 0:1, :]
    for k in range(1, 4):
        out = out + A[..., :, k:k + 1] * B[..., k:k + 1, :]
    return out


def _halve(v: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two) by halving steps, ``v[i] +
    v[i + h]``, and drop it."""
    h = v.shape[-1] // 2
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    return v[..., 0]


def error_fixed(T, src, valid, M, B) -> torch.Tensor:
    """``sum e^T M e`` at the pose ``T`` in ``ddlo_lm_inner``'s fixed order
    (per stream over a leading batch axis): per point ``_transform_points``,
    ``e = (B - src_t) * valid``, each row of ``M e`` and ``e . Me`` summed
    left to right; the points zero-padded to K rows of P = LM_CLUSTER *
    LM_THREADS partials, the rows summed left to right, then halving steps
    over the 32 lanes, the warps and the blocks."""
    src_t = _transform_points(T, src)
    e = (B - src_t) * valid.to(src.dtype)[..., None]
    e0, e1, e2 = e.unbind(-1)
    Me = [M[..., r, 0] * e0 + M[..., r, 1] * e1 + M[..., r, 2] * e2 for r in range(3)]
    q = e0 * Me[0] + e1 * Me[1] + e2 * Me[2]
    P = LM_CLUSTER * LM_THREADS
    N = q.shape[-1]
    K = max(1, -(-N // P))
    q = torch.nn.functional.pad(q, (0, K * P - N)).unflatten(-1, (K, P))
    acc = q[..., 0, :]
    for r in range(1, K):
        acc = acc + q[..., r, :]
    acc = _halve(acc.unflatten(-1, (LM_CLUSTER, LM_THREADS // 32, 32)))
    return _halve(_halve(acc))


def lm_inner_plain(x0, lam, H, b, src, valid, M, B, degenerate, run, s) -> TrialState:
    """The plain version of ``csrc/lm_trial.cu``'s ``ddlo_lm_inner``: the
    JAX package's lm_inner (one step_lm: lambda trials until one is
    accepted, convergence on a rejected step, or ``s.lm_max_iterations``
    trials) for every stream over the leading axes of ``lam``, as
    ``s.lm_max_iterations`` masked turns with no host read. A stream runs
    trials where ``run`` (None: all) and not ``degenerate``; one that has
    ended is left unchanged bit for bit. A trial is
    :func:`lm_propose_plain`, ``xi = delta x`` (:func:`_compose_ltr`), the
    error at ``xi`` (:func:`error_fixed`, as the starting error y0 is
    evaluated at ``x0``) and :func:`lm_decide_plain`. ``x0`` (..., 4, 4),
    ``H`` (..., 6, 6), ``b`` (..., 6), ``src`` / ``B`` (..., N, 3),
    ``valid`` (..., N), ``M`` (..., N, 3, 3). ``lam`` is updated in place;
    returns the :class:`TrialState` (``j``: each stream's trials)."""
    lead, dev = tuple(lam.shape), lam.device
    act = ~degenerate if run is None else run & ~degenerate
    st = TrialState(
        lam, torch.full(lead, 2.0, dtype=torch.float32, device=dev), x0.clone(),
        torch.eye(4, dtype=torch.float32, device=dev).expand(lead + (4, 4)).clone(),
        *(torch.zeros(lead, dtype=torch.bool, device=dev) for _ in range(3)), act.clone(),
        torch.zeros(lead, dtype=torch.int32, device=dev),
    )
    turns = torch.zeros((), dtype=torch.int32, device=dev)  # lm_decide_plain's one count
    y0 = error_fixed(x0, src, valid, M, B)
    for _ in range(s.lm_max_iterations):
        d, delta = lm_propose_plain(H, b, st.lam)
        xi = _compose_ltr(delta, st.x)
        yi = error_fixed(xi, src, valid, M, B)
        st.j.add_(st.act.to(torch.int32))
        lm_decide_plain(y0, yi, d, b, delta, xi, st._replace(j=turns), s)
    return st


def lm_inner(x0, lam, H, b, src, valid, M, B, degenerate, run, s) -> TrialState:
    """:func:`lm_inner_plain` on the card's terms: a CUDA ``lam`` launches
    ``csrc/lm_trial.cu``'s ``ddlo_lm_inner`` (one cluster of 8 blocks per
    stream runs its whole lambda loop; counted as ``lm_inner``) or raises;
    a CPU ``lam`` runs the plain version; any other device raises. Both
    give the same bits. ``B`` may be a strided view (the gathered target
    features' first three columns); every other tensor is made
    contiguous."""
    if not lam.is_cuda:
        if lam.device.type != "cpu":
            raise ValueError(f"lm_inner: no kernel for a tensor on {lam.device}")
        return lm_inner_plain(x0, lam, H, b, src, valid, M, B, degenerate, run, s)
    lead = tuple(lam.shape)
    N = src.shape[-2]
    x0, H, b, src, valid, M = (t.contiguous() for t in (x0, H, b, src, valid, M))
    f32, flag = torch.float32, torch.bool
    _check_card("lm_inner", [lam, x0, H, b, src, valid, M, degenerate, run],
                [lead, lead + (4, 4), lead + (6, 6), lead + (6,), lead + (N, 3), lead + (N,),
                 lead + (N, 3, 3), lead, lead], [f32] * 4 + [f32, flag, f32, flag, flag])
    if (B.device != lam.device or B.dtype != f32 or tuple(B.shape) != lead + (N, 3)
            or B.stride(-1) != 1):
        raise ValueError(f"lm_inner: expected B {lead + (N, 3)} f32 on {lam.device} with unit "
                         f"column stride, got {B.dtype} {tuple(B.shape)} strides {B.stride()}")
    nu = torch.empty(lead, dtype=f32, device=lam.device)
    x, delta_done = (torch.empty(lead + (4, 4), dtype=f32, device=lam.device) for _ in range(2))
    done, accepted, conv, act = (torch.empty(lead, dtype=flag, device=lam.device) for _ in range(4))
    j = torch.empty(lead, dtype=torch.int32, device=lam.device)
    lib = nn_cuda.build()["lm_trial"].lib
    nn_cuda.run_kernel(lib.ddlo_lm_inner, "lm_inner", x0, lam, H, b, src, valid, M, B,
                       B.stride(0) if lead else 0, B.stride(-2), run, degenerate, nu, x, delta_done,
                       done, accepted, conv, act, j, lam.numel(), N, s.lm_max_iterations,
                       s.rotation_epsilon, s.transformation_epsilon)  # ctypes rounds them to f32
    return TrialState(lam, nu, x, delta_done, done, accepted, conv, act, j)


# The card's arithmetic (eager PyTorch; it runs on any device). The LM
# loops take every rounding-sensitive step from one such namespace;
# ``gicp_xla`` has the same names but no ``lm_inner``: there a lambda
# loop runs its trials one by one. On the card a lambda loop is one
# launch (``lm_inner``); a point-sharded group's trial (its error summed
# over the ranks) and the GN step keep ``lm_propose`` / ``lm_decide``.
TORCH = types.SimpleNamespace(
    transform_points=_transform_points, compose=se3.compose,
    linearize_terms=_linearize_terms, error=_error,
    lm_propose=lm_propose, lm_decide=lm_decide, lm_inner=lm_inner,
)


def arithmetic(dev: torch.device):
    """GICP's arithmetic on ``dev``: on the host XLA's CPU rounding
    (``ops/gicp_xla.py``: the jitted JAX package's bits, numpy), on the
    card :data:`TORCH`."""
    return gicp_xla if dev.type == "cpu" else TORCH


def _allsum_fn(group):
    """Sum of tensors over the point-sharded process ``group``
    (``distributed.allsum``: the same bits on every rank), or the tensors
    as they are without one."""
    if group is None:
        return lambda *xs: xs
    from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed

    distributed.check_group(group)
    return lambda *xs: distributed.allsum(xs, group)


def _linearize(
    T: torch.Tensor,
    src_pts: torch.Tensor,
    src_mask: torch.Tensor,
    src_covs: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_covs: torch.Tensor,
    max_corr_dist: float,
    nn_impl: str = "auto",
    prune_dilation: float = 1.0,
    sparse_prep: nn_cuda.SparseTarget | None = None,
    tgt_feat: torch.Tensor | None = None,
    ar=None,
):
    """One GICP linearization at pose T: correspondences, Mahalanobis
    weights, error y0 = sum e^T M e and the normal equations H, b with
    J = [skew(T a) | -I]. Returns (y0, H, b, (idx, valid, M, B, sqd)).

    With a leading batch axis (T (B, 4, 4), clouds (B, N, 3), ...) every
    stream is linearized at once; ``sparse_prep`` is then a
    :class:`nn_cuda.BatchedSparseTarget` and the correspondences of all
    streams are one launch of the batched sparse kernel. ``ar``: the
    arithmetic (:func:`arithmetic` of the device by default)."""
    ar = arithmetic(src_pts.device) if ar is None else ar
    batched = src_pts.dim() == 3
    src_t = ar.transform_points(T, src_pts)
    src_t_q = torch.where(src_mask[..., None], src_t, SENTINEL)
    r = max_corr_dist * prune_dilation

    on_acc = device.on_accelerator(src_pts)
    if nn_impl == "sparse" and on_acc and batched:
        if sparse_prep is None:
            sparse_prep = nn_cuda.prepare_sparse_targets(tgt_pts)
        idx, sqd = nn_cuda.nn1_sparse_batched_prepared(src_t_q, sparse_prep, radius=r)
    elif nn_impl == "sparse" and on_acc:
        if sparse_prep is None:
            sparse_prep = nn_cuda.prepare_sparse_target(tgt_pts)
        idx, sqd = nn_cuda.nn1_sparse_prepared(src_t_q, sparse_prep, radius=r)
    else:
        # "exact"; "auto", "pallas", or "sparse" off the accelerator
        nn = knn_ops.nn1 if nn_impl == "exact" else knn_ops.nn1_best
        if batched:
            idx, sqd = (torch.stack(v) for v in zip(*map(nn, src_t_q, tgt_pts)))
        else:
            idx, sqd = nn(src_t_q, tgt_pts)
    # invalid targets sit at the SENTINEL: the gate below discards them
    valid = src_mask & (sqd < max_corr_dist * max_corr_dist)
    vf = valid.to(src_pts.dtype)
    if tgt_feat is None:
        tgt_feat = torch.cat([tgt_pts, tgt_covs.flatten(-2)], dim=-1)
    # the exact sweeps may return a padded target row for a sentinel
    # query (distance 0 to the 1e6 padding); clamp like a JAX gather
    sel = idx.long().clamp_max(tgt_feat.shape[-2] - 1)
    if batched:
        feat = torch.gather(tgt_feat, 1, sel[..., None].expand(-1, -1, tgt_feat.shape[-1]))
    else:
        feat = tgt_feat[sel]
    B = feat[..., :3]
    cov_B = feat[..., 3:].unflatten(-1, (3, 3))
    M, y0, H, b = ar.linearize_terms(src_t, vf, T[..., :3, :3], cov_B, src_covs, B)
    return y0, H, b, (idx, valid, M, B, sqd)


def _compute_error(T, src_pts, aux, ar):
    """sum e^T M e at a candidate pose, correspondences and weights held
    from the last linearization (per stream over a leading batch axis)."""
    _, valid, M, B, _ = aux
    return ar.error(ar.transform_points(T, src_pts), valid.to(src_pts.dtype), M, B)


def _conv_eps(s: GICPSettings, dev) -> tuple:
    """The convergence test's epsilons as f32 tensors on ``dev``: a
    division by a tensor is an f32 division on every device (by a Python
    scalar, PyTorch's CUDA division rounds otherwise; the LM kernel
    divides)."""
    return tuple(torch.full((), e, dtype=torch.float32, device=dev)
                 for e in (s.rotation_epsilon, s.transformation_epsilon))


def _is_converged(delta: torch.Tensor, eps: tuple) -> torch.Tensor:
    """Reference convergence test (lsq_registration_impl.hpp:129-139), per
    pose of (..., 4, 4); ``eps``: :func:`_conv_eps`."""
    eye = torch.eye(3, dtype=delta.dtype, device=delta.device)
    Rd = torch.abs(delta[..., :3, :3] - eye) / eps[0]
    td = torch.abs(delta[..., :3, 3]) / eps[1]
    return torch.maximum(torch.amax(Rd, dim=(-2, -1)), torch.amax(td, dim=-1)) < 1.0


def align(
    src_pts: torch.Tensor,
    src_mask: torch.Tensor,
    src_covs: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_covs: torch.Tensor,
    guess: torch.Tensor,
    settings: GICPSettings = GICPSettings(),
    axis_name: torch.distributed.ProcessGroup | None = None,
) -> GICPResult:
    """GICP alignment: T minimizing sum (b - T a)^T M (b - T a), by the
    LM stepper (lsq_registration_impl.hpp:176-232) or the GN stepper
    (:156-173), with the JAX package's degenerate-H guard, rho 0/0 guard
    and final residual pass.

    ``axis_name``: a ``torch.distributed`` process group (a mesh's
    ``pt_group``, the JAX package's mesh axis). The SOURCE rows are this
    rank's share of a point-sharded cloud; the normal equations
    (y0, H, b), every error re-evaluation and the inlier count are summed
    over the group inside every LM iteration. The target is whole on
    every rank; residuals and correspondences stay the shard's own."""
    allsum = _allsum_fn(axis_name)
    s = settings
    dev = src_pts.device
    f32 = torch.float32
    ar = arithmetic(dev)
    tgt_q = torch.where(tgt_mask[:, None], tgt_pts, SENTINEL)

    # target-side sparse prep and packed winner features, hoisted out of
    # the optimization loop (the target never moves)
    sparse_prep = None
    if device.on_accelerator(tgt_pts) and s.nn_impl == "sparse":
        sparse_prep = nn_cuda.prepare_sparse_target(tgt_q)
    tgt_feat = torch.cat([tgt_q, tgt_covs.reshape(tgt_pts.shape[0], 9)], dim=1)

    def lin(T, nn_impl=s.nn_impl, prune_dilation=1.0):
        y0, H, b, aux = _linearize(
            T, src_pts, src_mask, src_covs, tgt_q, tgt_mask, tgt_covs,
            s.max_correspondence_distance, nn_impl, prune_dilation,
            sparse_prep=sparse_prep, tgt_feat=tgt_feat, ar=ar,
        )
        return (*allsum(y0, H, b), aux)

    eye6 = torch.eye(6, dtype=f32, device=dev)
    lam_gn = torch.full((), 1e-12, dtype=f32, device=dev)
    eps = _conv_eps(s, dev)

    fused = getattr(ar, "lm_inner", None) if axis_name is None else None

    def lm_inner(x, lam, y0, H, b, aux, skip):
        """One step_lm in place: loop over lambda until a step is accepted
        (rho >= 0), convergence is detected on a rejected step, or
        lm_max_iterations is exhausted (``skip``: not at all). ``lam`` is
        updated; returns the :class:`TrialState` (its ``x`` the new
        pose). Without a group the card's arithmetic runs the whole loop
        in one call (``TORCH.lm_inner``)."""
        if fused is not None:
            _, valid, M, B, _ = aux
            return fused(x, lam, H, b, src_pts, valid, M, B, skip, None, s)
        x = x.clone()
        st = TrialState(
            lam, torch.full((), 2.0, dtype=f32, device=dev), x, torch.eye(4, dtype=f32, device=dev),
            *(torch.zeros((), dtype=torch.bool, device=dev) for _ in range(3)),
            torch.ones((), dtype=torch.bool, device=dev), torch.zeros((), dtype=torch.int32, device=dev),
        )

        def more(*_):
            return control.Test(st.j, s.lm_max_iterations, none_of=(st.done, skip))

        def trial(*_):
            # a trial runs only while the stream is active: act stays true
            d, delta = ar.lm_propose(H, b, lam)
            xi = ar.compose(delta, x)
            (yi,) = allsum(_compute_error(xi, src_pts, aux, ar))
            ar.lm_decide(y0, yi, d, b, delta, xi, st, s)

        control.while_loop(more, trial, ())
        return st

    # the LM state, updated in place by the iterations (lax.while_loop's
    # carry: the pose, lambda, the flags, the count, the last error and
    # Hessian, the trace)
    x0 = guess.to(f32).clone()
    lm_lambda = torch.full((), -1.0, dtype=f32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    failed = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    y_st = torch.zeros((), dtype=f32, device=dev)
    H_st = eye6.clone()
    trace = torch.zeros((s.max_iterations if s.record_trace else 0, 4, 4), dtype=f32, device=dev)

    def running(*_):
        return control.Test(it, s.max_iterations, none_of=(converged, failed))

    def iteration(*_):
        y0, H, b, aux = lin(x0)
        hmax = torch.max(torch.abs(torch.diagonal(H)))
        lam = torch.where(lm_lambda < 0, s.lm_init_lambda_factor * hmax, lm_lambda)
        # degenerate normal equations (no correspondence inside the
        # gate): stop with the pose unchanged
        degenerate = hmax < 1e-12
        if s.optimizer == "gn":
            _, delta = ar.lm_propose(H, b, lam_gn, degenerate)
            x_new = ar.compose(delta, x0)
            conv_new = degenerate | _is_converged(delta, eps)
            H_st.copy_(H)
        else:
            st = lm_inner(x0, lam, y0, H, b, aux, degenerate)
            profiling.count(dev, "lm_trials", st.j)
            x_new = st.x
            conv_new = degenerate | st.conv | (st.accepted & _is_converged(st.delta_done, eps))
            failed.copy_(~st.done & ~degenerate)  # lm_max_iterations exhausted
            H_st.copy_(torch.where(st.accepted & ~degenerate, H, H_st))
        converged.copy_(conv_new)
        y_st.copy_(y0)
        lm_lambda.copy_(lam)
        if s.record_trace:
            trace.index_copy_(0, it.long().reshape(1), x_new[None])
        x0.copy_(x_new)
        it.add_(1)

    control.while_loop(running, iteration, ())

    if s.compute_residuals:
        # final per-point NN residuals at the final pose; the sparse
        # backend dilates its pruning radius 3x and clamps there, the
        # exact backends clamp at 1e3 (see the JAX package's align)
        if s.nn_impl == "sparse":
            y_fin, H_fin, _, aux = lin(x0, "sparse", prune_dilation=3.0)
            res_cap = 3.0 * s.max_correspondence_distance
        else:
            y_fin, H_fin, _, aux = lin(x0)
            res_cap = 1.0e3
        idx, valid, _, _, sqd = aux
        residuals = torch.clamp_max(_sqrt_rn(torch.clamp_min(sqd, 0.0)), res_cap) * src_mask
        corr = torch.where(valid, idx, -1).to(torch.int32)
        (num_inliers,) = allsum(valid.sum(dtype=torch.int32))
    else:
        y_fin, H_fin = y_st, H_st
        residuals = torch.zeros(src_pts.shape[0], dtype=f32, device=dev)
        corr = torch.full((src_pts.shape[0],), -1, dtype=torch.int32, device=dev)
        (num_inliers,) = allsum(src_mask.sum(dtype=torch.int32))
    if s.record_trace:
        # rows past the count repeat the final pose
        rows = torch.arange(s.max_iterations, device=dev) < it
        pose_trace = torch.where(rows[:, None, None], trace, x0)
    else:
        pose_trace = trace
    return GICPResult(
        T=x0,
        converged=converged & (num_inliers > 0),
        iterations=it,
        final_error=y_fin,
        final_hessian=H_fin,
        num_inliers=num_inliers,
        residuals=residuals,
        correspondences=corr,
        pose_trace=pose_trace,
    )


def align_batch(
    src_pts: torch.Tensor,
    src_mask: torch.Tensor,
    src_covs: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_mask: torch.Tensor,
    tgt_covs: torch.Tensor,
    guess: torch.Tensor,
    settings: GICPSettings = GICPSettings(),
    axis_name: torch.distributed.ProcessGroup | None = None,
) -> GICPResult:
    """B independent :func:`align` calls over a leading batch axis (the
    JAX package's ``jax.vmap(gicp.align)``): ``src_pts`` (B, N, 3) ...
    ``guess`` (B, 4, 4); every field of the result has a leading B.
    ``axis_name`` sums every stream's normal equations, errors and
    inliers over a point-sharded process group, as in :func:`align`.

    A vmapped ``while_loop`` runs its body for every stream while any
    stream's predicate holds and keeps each finished stream's carry: so
    here do the outer LM loop and the inner lambda loop, each a
    ``core/control.while_loop`` whose predicate is "any stream still
    running" (on the card inside a captured graph a WHILE node decides it
    on the device; outside one the loop reads only that predicate), with
    a per-stream ``active`` mask and ``torch.where`` on the carry. A
    stream's pose, iteration count and inliers are what :func:`align`
    gives it. Every linearization is one batched pass; with
    ``nn_impl="sparse"`` on the card its correspondences are one launch of
    the batched sparse 1-NN kernel for all streams."""
    allsum = _allsum_fn(axis_name)
    s = settings
    Bn, dev, f32 = src_pts.shape[0], src_pts.device, torch.float32
    ar = arithmetic(dev)
    tgt_q = torch.where(tgt_mask[..., None], tgt_pts, SENTINEL)
    sparse_prep = None
    if device.on_accelerator(tgt_pts) and s.nn_impl == "sparse":
        sparse_prep = nn_cuda.prepare_sparse_targets(tgt_q)
    tgt_feat = torch.cat([tgt_q, tgt_covs.flatten(-2)], dim=-1)

    def lin(T, nn_impl=s.nn_impl, prune_dilation=1.0):
        y0, H, b, aux = _linearize(
            T, src_pts, src_mask, src_covs, tgt_q, tgt_mask, tgt_covs,
            s.max_correspondence_distance, nn_impl, prune_dilation,
            sparse_prep=sparse_prep, tgt_feat=tgt_feat, ar=ar,
        )
        return (*allsum(y0, H, b), aux)

    eye6 = torch.eye(6, dtype=f32, device=dev)
    eye4 = torch.eye(4, dtype=f32, device=dev).expand(Bn, 4, 4)
    lam_gn = torch.full((Bn,), 1e-12, dtype=f32, device=dev)
    eps = _conv_eps(s, dev)

    def flags(n=1):
        return (torch.zeros(Bn, dtype=torch.bool, device=dev) for _ in range(n))

    fused = getattr(ar, "lm_inner", None) if axis_name is None else None

    def lm_inner(run, degenerate, x0, lam, y0, H, b, aux):
        """step_lm for the streams in ``run`` that are not degenerate,
        frozen per stream as in :func:`align`'s inner loop; ``lam`` is
        updated in place. Returns the :class:`TrialState`. Without a
        group the card's arithmetic runs every stream's loop in one call
        (``TORCH.lm_inner``)."""
        if fused is not None:
            _, valid, M, B, _ = aux
            return fused(x0, lam, H, b, src_pts, valid, M, B, degenerate, run, s)
        st = TrialState(lam, torch.full((Bn,), 2.0, dtype=f32, device=dev), x0.clone(), eye4.clone(),
                        *flags(3), run & ~degenerate, torch.zeros((), dtype=torch.int32, device=dev))

        def more(*_):
            return control.Test(st.j, s.lm_max_iterations, all_of=(st.act,))

        def trial(*_):
            d, delta = ar.lm_propose(H, b, lam)
            xi = ar.compose(delta, st.x)
            (yi,) = allsum(_compute_error(xi, src_pts, aux, ar))
            ar.lm_decide(y0, yi, d, b, delta, xi, st, s)

        control.while_loop(more, trial, ())
        return st

    # the LM state of every stream, updated in place by the iterations
    # (the vmapped lax.while_loop's carry; ``k`` counts the loop's passes)
    x0 = guess.to(f32).clone()
    lm_lambda = torch.full((Bn,), -1.0, dtype=f32, device=dev)
    y_st = torch.zeros((Bn,), dtype=f32, device=dev)
    H_st = eye6.expand(Bn, 6, 6).clone()
    converged, failed = flags(2)
    it = torch.zeros((Bn,), dtype=torch.int32, device=dev)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    trace = torch.zeros((Bn, s.max_iterations if s.record_trace else 0, 4, 4), dtype=f32, device=dev)

    def running(*_):
        return control.Test(k, s.max_iterations, none_of=(converged, failed))

    def iteration(*_):
        run = ~converged & ~failed
        y0, H, b, aux = lin(x0)
        hmax = torch.amax(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), dim=-1)
        lam = torch.where(lm_lambda < 0, s.lm_init_lambda_factor * hmax, lm_lambda)
        degenerate = hmax < 1e-12
        if s.optimizer == "gn":
            _, delta = ar.lm_propose(H, b, lam_gn, degenerate)
            x_new = ar.compose(delta, x0)
            conv_new = degenerate | _is_converged(delta, eps)
            H_new = H
        else:
            st = lm_inner(run, degenerate, x0, lam, y0, H, b, aux)
            profiling.count(dev, "lm_trials", st.j.sum())
            x_new = st.x  # a degenerate stream runs no trial: x0
            conv_new = degenerate | st.conv | (st.accepted & _is_converged(st.delta_done, eps))
            failed.logical_or_(run & ~degenerate & ~st.done)
            H_new = _sel(st.accepted, H, H_st)
        y_st.copy_(torch.where(run, y0, y_st))
        H_st.copy_(_sel(run, H_new, H_st))
        lm_lambda.copy_(torch.where(run, lam, lm_lambda))
        converged.logical_or_(run & conv_new)
        x0.copy_(_sel(run, x_new, x0))
        it.add_(run.to(torch.int32))
        if s.record_trace:
            trace.index_copy_(1, k.long().reshape(1), x0[:, None])
        k.add_(1)

    control.while_loop(running, iteration, ())

    if s.compute_residuals:
        if s.nn_impl == "sparse":
            y_fin, H_fin, _, aux = lin(x0, "sparse", prune_dilation=3.0)
            res_cap = 3.0 * s.max_correspondence_distance
        else:
            y_fin, H_fin, _, aux = lin(x0)
            res_cap = 1.0e3
        idx, valid, _, _, sqd = aux
        residuals = torch.clamp_max(_sqrt_rn(torch.clamp_min(sqd, 0.0)), res_cap) * src_mask
        corr = torch.where(valid, idx, -1).to(torch.int32)
        (num_inliers,) = allsum(valid.sum(dim=-1, dtype=torch.int32))
    else:
        y_fin, H_fin = y_st, H_st
        residuals = torch.zeros(src_pts.shape[:2], dtype=f32, device=dev)
        corr = torch.full(src_pts.shape[:2], -1, dtype=torch.int32, device=dev)
        (num_inliers,) = allsum(src_mask.sum(dim=-1, dtype=torch.int32))
    if s.record_trace:
        # a stream's k-th pose is the k-th pass's; rows past its count
        # repeat its final pose, as align's do
        rows = torch.arange(s.max_iterations, device=dev) < it[:, None]
        pose_trace = torch.where(rows[..., None, None], trace, x0[:, None])
    else:
        pose_trace = trace
    return GICPResult(
        T=x0,
        converged=converged & (num_inliers > 0),
        iterations=it,
        final_error=y_fin,
        final_hessian=H_fin,
        num_inliers=num_inliers,
        residuals=residuals,
        correspondences=corr,
        pose_trace=pose_trace,
    )

"""Seeded inputs of GICP's lambda trial (``ops/gicp.lm_propose`` /
``lm_decide``), numpy and torch only: tests/test_torch_lm_kernel.py holds
the plain versions to the JAX package on them, and ``chip_smoke.py``
phase 3 holds the kernels to the plain versions on them."""

import numpy as np
import torch

from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp

S = gicp.GICPSettings()


def _spd(rng, B, cols=6, scale=30.0):
    X = rng.normal(size=(B, 60, 6)) * scale
    if cols < 6:  # the last columns nearly copies of the first: near-singular
        X[:, :, cols:] = X[:, :, : 6 - cols] + rng.normal(size=(B, 60, 6 - cols)) * scale * 3e-2
    return np.einsum("bki,bkj->bij", X, X).astype(np.float32)


def propose_cases(seed=0):
    """(name, H, b, lam, zero) at B = 1 and 8: b sized so that d is a
    GICP-like step (1e-3 rad / m), or tiny for the small-angle branch."""
    rng = np.random.default_rng(seed)
    out = []
    for B in (1, 8):
        def lam(H, f=1e-9):
            return (np.abs(np.diagonal(H, axis1=1, axis2=2)).max(1) * f).astype(np.float32)

        def rhs(H, size):
            return (np.einsum("bij,bj->bi", H, rng.normal(size=(B, 6)) * size)).astype(np.float32)

        H = _spd(rng, B)
        out.append((f"spd_B{B}", H, rhs(H, 1e-3), lam(H), None))
        H = _spd(rng, B)
        out.append((f"spd_large_lambda_B{B}", H, rhs(H, 1e-2), lam(H, rng.uniform(1e-3, 10)), None))
        H = _spd(rng, B, cols=5)
        out.append((f"near_singular_B{B}", H, rhs(H, 1e-3), lam(H), None))
        H = _spd(rng, B)
        out.append((f"small_angle_B{B}", H, rhs(H, 1e-8), lam(H), None))
        out.append((f"d_zero_B{B}", H, np.zeros((B, 6), np.float32), lam(H), None))
        # dim 4 decoupled, its pivot 1e-31: the guard makes it 1e-30
        H = _spd(rng, B)
        H[:, 4, :] = 0.0
        H[:, :, 4] = 0.0
        H[:, 4, 4] = 1e-31
        b = rhs(H, 1e-3)
        b[:, 4] = 1e-32
        out.append((f"pivot_B{B}", H, b, np.zeros(B, np.float32), None))
        H = _spd(rng, B)
        zero = np.arange(B) % 2 == 0
        out.append((f"gn_zero_B{B}", H, rhs(H, 1e-3), np.full(B, 1e-12, np.float32), zero))
    return out


def as_tensors(*xs):
    return [None if x is None else torch.from_numpy(np.array(x)) for x in xs]


def decide_batch(seed=0, B=8):
    """One trial's inputs and state for B streams, each a scenario:
    accept, reject-and-grow, converge-on-reject, the 0/0 guard (d = 0,
    y0 = yi), or frozen (not active); (inputs, state as numpy, kinds)."""
    rng = np.random.default_rng(seed)
    kinds = np.array(["accept", "grow", "conv_reject", "zero_step", "frozen"])[np.arange(B) % 5]
    H = _spd(rng, B)
    lam = (rng.uniform(1e-6, 1e2, B)).astype(np.float32)
    size = np.where(kinds == "conv_reject", 1e-6, 1e-2)
    b = np.einsum("bij,bj->bi", H, rng.normal(size=(B, 6)) * size[:, None]).astype(np.float32)
    b[kinds == "zero_step"] = 0.0
    d, delta = gicp.lm_propose_plain(*as_tensors(H, b, lam))
    x = torch.from_numpy(np.array([pose(rng) for _ in range(B)]))
    xi = torch.matmul(delta, x)
    y0 = rng.uniform(10, 100, B).astype(np.float32)
    yi = np.where(kinds == "accept", y0 * 0.5, y0 * 1.5).astype(np.float32)
    yi[kinds == "zero_step"] = y0[kinds == "zero_step"]
    st = gicp.TrialState(
        lam=torch.from_numpy(lam), nu=torch.from_numpy(rng.choice([2.0, 4.0, 8.0], B).astype(np.float32)),
        x=x, delta_done=torch.from_numpy(np.array([pose(rng) for _ in range(B)])),
        done=torch.from_numpy(kinds == "frozen"), accepted=torch.from_numpy(rng.random(B) < 0.3),
        conv=torch.zeros(B, dtype=torch.bool), act=torch.from_numpy(kinds != "frozen"),
        j=torch.tensor(3, dtype=torch.int32),
    )
    return (torch.from_numpy(y0), torch.from_numpy(yi), d, torch.from_numpy(b), delta, xi), st, kinds


def boundary_batch(B=256):
    """Rejected trials whose convergence test lands within ulps of its
    bar: |t_x| / trans_eps (the first half) and |R_12| / rot_eps (the
    second) step through 1.0 an ulp at a time, so that a division rounded
    otherwise than in f32 decides another way."""
    f = np.float32
    rng = np.random.default_rng(9)
    h = B // 2
    delta = np.tile(np.eye(4, dtype=f), (B, 1, 1))
    for rows, eps, (r, c) in ((slice(0, h), S.transformation_epsilon, (0, 3)),
                              (slice(h, B), S.rotation_epsilon, (1, 2))):
        e = f(eps)
        delta[rows, r, c] = (e + (np.arange(h) - h // 2).astype(f) * np.spacing(e)).astype(f)
    d = (rng.normal(size=(B, 6)) * 1e-3).astype(f)
    b = (rng.normal(size=(B, 6)) * 10).astype(f)
    x = torch.from_numpy(np.array([pose(rng) for _ in range(B)]))
    delta = torch.from_numpy(delta)
    y0 = rng.uniform(10, 100, B).astype(f)
    st = gicp.TrialState(
        lam=torch.from_numpy(rng.uniform(1e-6, 1e2, B).astype(f)), nu=torch.full((B,), 2.0),
        x=x, delta_done=torch.eye(4).expand(B, 4, 4).clone(), done=torch.zeros(B, dtype=torch.bool),
        accepted=torch.zeros(B, dtype=torch.bool), conv=torch.zeros(B, dtype=torch.bool),
        act=torch.ones(B, dtype=torch.bool), j=torch.tensor(0, dtype=torch.int32),
    )
    ins = (torch.from_numpy(y0), torch.from_numpy(y0 * f(1.5)), torch.from_numpy(d), torch.from_numpy(b),
           delta, torch.matmul(delta, x))
    return ins, st, np.full(B, "boundary")


DECIDE_CASES = {**{f"scenarios_{i}": (lambda i=i: decide_batch(i)) for i in range(3)},
                "convergence_boundary": boundary_batch}


def pose(rng):
    T = np.eye(4, dtype=np.float32)
    a = rng.uniform(-np.pi, np.pi)
    T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
    T[:3, 3] = rng.uniform(-10, 10, 3)
    return T


def half_angle_sweep(n=1 << 20):
    """(H, b, lam) of n streams whose step is d = -b exactly (H = I,
    lam = 0), its angle sweeping [0, 2 pi] densely and [1e-8, 1e-2] on a
    log scale, so that the kernel's sinf / cosf meet torch.sin / torch.cos
    on every half-angle of the sweep."""
    theta = torch.cat([torch.linspace(0, 2 * np.pi, n - 4096), torch.logspace(-8, -2, 4096)])
    b = torch.zeros((n, 6))
    b[:, 0], b[:, 3] = -theta, 1.0
    return torch.eye(6).expand(n, 6, 6).contiguous(), b, torch.zeros(n)


# the streams of an lm_inner batch, in turn (``inner_case``)
INNER_KINDS = ("free", "reject_to_cap", "d_zero", "degenerate", "not_run", "far")


def _rot(axis, a):
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (0, 2), (0, 1)][axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def inner_case(B, N, seed=0, kinds=None, lead=True):
    """The inputs of ``gicp.lm_inner`` for B GICP-like streams of N
    points: (x0, lam, H, b, src, valid, M, Bv, degenerate, run), torch on
    the CPU, ``Bv`` a strided view of (B, N, 12) gathered features as the
    linearization leaves it. Targets are the sources under a pose near
    the identity plus noise; x0 starts off it; M, H and b come from the
    card arithmetic's linearization (``gicp._linearize_terms``) at x0.
    Stream s is of kind ``kinds[s]`` (default: ``INNER_KINDS`` in turn):
    "free" a plain loop; "far" x0 farther off; "reject_to_cap" with b
    negated and scaled by 1e4, so every step climbs and the loop runs to lm_max_iterations;
    "d_zero" with b = 0, a step d = 0; "degenerate" and "not_run" run no
    trial. ``lead=False`` (B = 1): no batch axis, as ``align`` calls it."""
    rng = np.random.default_rng(seed)
    kinds = [INNER_KINDS[s % len(INNER_KINDS)] for s in range(B)] if kinds is None else list(kinds)
    f = np.float32
    src = rng.uniform(-20, 20, (B, N, 3)).astype(f)
    x0 = np.tile(np.eye(4, dtype=f), (B, 1, 1))
    tgt = np.empty_like(src)
    for s in range(B):
        R = _rot(2, 0.03 + 0.01 * s) @ _rot(0, 0.01)
        tgt[s] = src[s] @ R.T + np.array([0.2, -0.1, 0.05]) + rng.normal(0, 0.02, (N, 3))
        off = 0.05 if kinds[s] == "far" else 0.01
        x0[s, :3, :3] = (_rot(1, off) @ _rot(2, -off)).astype(f)
        x0[s, :3, 3] = rng.uniform(-off, off, 3)

    def covs(k):
        A = rng.normal(0, 1, (B, k, 3, 3)).astype(f)
        return (A @ A.transpose(0, 1, 3, 2) * 0.01 + np.eye(3, dtype=f) * 1e-3).astype(f)

    src_covs, cov_B = covs(N), covs(N)
    valid = rng.random((B, N)) < 0.9
    feat = torch.from_numpy(np.concatenate([tgt.astype(f), cov_B.reshape(B, N, 9)], axis=-1))
    Bv = feat[..., :3]
    x0t, srct = torch.from_numpy(x0), torch.from_numpy(src)
    vf = torch.from_numpy(valid).float()
    src_t = gicp._transform_points(x0t, srct)
    M, _, H, b = gicp._linearize_terms(src_t, vf, x0t[:, :3, :3], torch.from_numpy(cov_B),
                                       torch.from_numpy(src_covs), Bv)
    kind = np.array(kinds)
    # a climbing step large enough that lambda's growth (nu doubles on
    # each reject) leaves it above the convergence bar for 10 trials
    b = torch.where(torch.from_numpy(kind == "reject_to_cap")[:, None], b * -1e4, b)
    b = torch.where(torch.from_numpy(kind == "d_zero")[:, None], 0.0, b)
    lam = torch.diagonal(H, dim1=-2, dim2=-1).abs().amax(-1) * 1e-9
    degenerate = torch.from_numpy(kind == "degenerate")
    run = torch.from_numpy(kind != "not_run")
    out = [x0t, lam, H.contiguous(), b.contiguous(), srct, torch.from_numpy(valid), M.contiguous(), Bv,
           degenerate, run]
    if not lead:
        assert B == 1
        out = [x[0] for x in out]
    return out

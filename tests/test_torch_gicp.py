"""GICP (ops/gicp.py) against the JAX package.

Bars: inv3x3 / solve6_ldlt rtol 1e-5; one linearization y0, H, b rtol
1e-4 with the valid correspondence sets equal, on the exact (CPU) path
and on the sparse accelerator path (port: forced, so the kernel's plain
version runs; JAX: backend patched to "tpu", Pallas interpreted);
``align`` LM and GN on a displaced pair: final pose within 1e-4 m and
1e-4 rad, equal iteration counts, every recorded iterate within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from test_gicp import make_structured_scene
from torch_parity import jax_tpu_paths, n, port_accelerator_paths, rot_err, t

from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov
from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(200, 3, 3)).astype(np.float32)
    m = (a @ a.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    np.testing.assert_allclose(
        n(gicp.inv3x3(t(m))), np.asarray(jgicp.inv3x3(jnp.asarray(m))), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve6_ldlt_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(6, 6)).astype(np.float32)
    A = (a @ a.T + 1e-2 * np.eye(6)).astype(np.float32)
    b = rng.normal(size=6).astype(np.float32)
    np.testing.assert_allclose(
        n(gicp.solve6_ldlt(t(A), t(b))),
        np.asarray(jgicp.solve6_ldlt(jnp.asarray(A), jnp.asarray(b))),
        rtol=1e-5, atol=1e-6,
    )


def _pair(n_pts, seed=0, rot_deg=4.0, trans=0.25):
    """Target scene, source = target moved by a known motion (+ noise),
    shared PLANE covariances (JAX exact path, so both sides see the
    same), and the initial guess (identity)."""
    rng = np.random.default_rng(seed)
    tgt = make_structured_scene(rng, n=n_pts)
    rv = rng.normal(size=3)
    rv *= np.deg2rad(rot_deg) / np.linalg.norm(rv)
    R = Rotation.from_rotvec(rv).as_matrix().astype(np.float32)
    tr = (trans * rng.normal(size=3)).astype(np.float32)
    src = ((tgt - tr) @ R + rng.normal(0, 0.005, tgt.shape)).astype(np.float32)
    mask = np.ones(len(tgt), bool)
    mask[::29] = False
    src[~mask] = 1.0e6
    tgt_m = np.ones(len(tgt), bool)
    covs_s = np.asarray(jcov.plane_covariances(jnp.asarray(src), jnp.asarray(mask), k=20))
    covs_t = np.asarray(jcov.plane_covariances(jnp.asarray(tgt), jnp.asarray(tgt_m), k=20))
    return src, mask, covs_s, tgt, tgt_m, covs_t


def _lin_both(args, T, nn_impl, **kw):
    j = jgicp._linearize(jnp.asarray(T), *map(jnp.asarray, args), 1.0, nn_impl, **kw)
    p = gicp._linearize(t(T), *map(t, args), 1.0, nn_impl, **kw)
    return j, p


def _check_lin(j, p):
    (jy, jH, jb, jaux), (py, pH, pb, paux) = j, p
    np.testing.assert_allclose(float(py), float(jy), rtol=1e-4)
    np.testing.assert_allclose(n(pH), np.asarray(jH), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(n(pb), np.asarray(jb), rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(n(paux[1]), np.asarray(jaux[1]))  # valid sets
    v = np.asarray(jaux[1])
    np.testing.assert_array_equal(n(paux[0])[v], np.asarray(jaux[0])[v])  # winners


def test_linearize_exact_path_matches_jax():
    args = _pair(1200, seed=3)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.05, 0.02]
    _check_lin(*_lin_both(args, T, "exact"))
    _check_lin(*_lin_both(args, T, "sparse"))  # off the accelerator: exact sweep


def test_linearize_sparse_path_matches_jax():
    args = _pair(1100, seed=4)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, 0.1, -0.02]
    with jax_tpu_paths(), port_accelerator_paths():
        j, p = _lin_both(args, T, "sparse", prune_dilation=1.0)
    _check_lin(j, p)


@pytest.mark.parametrize(
    "optimizer,accelerator", [("lm", False), ("gn", False), ("lm", True)]
)
def test_align_matches_jax(optimizer, accelerator):
    # distinct sizes per case: the JAX traces are cached by shape
    npts = {("lm", False): 2000, ("gn", False): 2100, ("lm", True): 2200}[
        (optimizer, accelerator)
    ]
    src, mask, covs_s, tgt, tgt_m, covs_t = _pair(npts, seed=5)
    settings = dict(
        max_correspondence_distance=1.0, optimizer=optimizer, record_trace=True,
        nn_impl="sparse", max_iterations=32,
    )
    guess = np.eye(4, dtype=np.float32)
    args = (src, mask, covs_s, tgt, tgt_m, covs_t, guess)
    if accelerator:
        with jax_tpu_paths(), port_accelerator_paths():
            jr = jgicp.align(*map(jnp.asarray, args), jgicp.GICPSettings(**settings))
            pr = gicp.align(*map(t, args), gicp.GICPSettings(**settings))
    else:
        jr = jgicp.align(*map(jnp.asarray, args), jgicp.GICPSettings(**settings))
        pr = gicp.align(*map(t, args), gicp.GICPSettings(**settings))
    jT, pT = np.asarray(jr.T), n(pr.T)
    assert bool(jr.converged) and bool(pr.converged)
    assert int(pr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(pT[:3, 3], jT[:3, 3], atol=1e-4)
    assert rot_err(pT[:3, :3], jT[:3, :3]) < 1e-4
    np.testing.assert_allclose(n(pr.pose_trace), np.asarray(jr.pose_trace), atol=1e-4)
    assert int(pr.num_inliers) == int(jr.num_inliers)
    np.testing.assert_allclose(n(pr.residuals), np.asarray(jr.residuals), atol=1e-4)


def test_align_degenerate_and_no_residuals_match_jax():
    """No correspondence inside the gate: the pose stays the guess, the
    result stays finite; compute_residuals=False fills -1 / zeros."""
    src, mask, covs_s, tgt, tgt_m, covs_t = _pair(600, seed=6)
    far = (src + 100.0).astype(np.float32)
    s = dict(compute_residuals=False)
    args = (far, mask, covs_s, tgt, tgt_m, covs_t, np.eye(4, dtype=np.float32))
    jr = jgicp.align(*map(jnp.asarray, args), jgicp.GICPSettings(**s))
    pr = gicp.align(*map(t, args), gicp.GICPSettings(**s))
    np.testing.assert_array_equal(n(pr.T), np.asarray(jr.T))
    assert bool(pr.converged) == bool(jr.converged)
    assert int(pr.iterations) == int(jr.iterations)
    assert torch.all(pr.correspondences == -1) and torch.all(pr.residuals == 0)
    assert int(pr.num_inliers) == int(jr.num_inliers)

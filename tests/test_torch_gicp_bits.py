"""The port's GICP arithmetic against the jitted JAX package on the CPU
(``ops/gicp_xla.py``: XLA's FMA contractions, its tree for the error sum,
its fused chain or Eigen's GEMV for ``b``, and Eigen's grouping of H's
rows into partial sums, as probed with ``tools/torch_jax_gaps.py
--probe``), and the card's arithmetic (``gicp.TORCH``) run on the host.

- Bit for bit where the order is XLA's own loop code, or a sum that does
  not depend on the host's threads: the Mahalanobis weights (K = 3
  products and the inverse), y0, ``b``, and H below 10,752 rows (512 to
  2,048 points); the LDLT solve, ``se3_exp`` and the 4x4 compose.
- H from 10,752 rows (4,000 and 4,096 points) is summed by Eigen over
  its threads, and JAX's own H then depends on the host: a default JAX
  process gives other bits on one core (``taskset -c 0``) than on 8, up
  to 2 ulp of the row's largest entry at these sizes and 3 at 16,384
  points (``XLA_FLAGS= python tools/torch_jax_gaps.py --h N``). The port
  is held to 3 ulp of the row's largest entry, JAX's own spread; on the
  8-core Xeon where the rules were read it is 0.
- The LM trace and the final pose (1,024 points) within 1e-6, with equal
  iteration and inlier counts; measured bit-equal on that host.
- The card's arithmetic on the host: H and b within 1e-5 of the largest
  entry, y0 within 1e-5 relative, and its align within 1e-6 of JAX's pose
  with the same iteration count (measured: H within 3.2e-7 of its largest
  entry, the pose within 3.2e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu.core import se3 as jse3
from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, gicp_xla


def _inputs(N, seed):
    """A scene-like pair: targets in a box, sources near them (95 % of
    either mask set), PLANE-like covariances, a small rotation."""
    M = 4 * N
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-10, 10, (M, 3)).astype(np.float32)
    src = (tgt[rng.integers(0, M, N)] + rng.normal(0, 0.05, (N, 3))).astype(np.float32)

    def covs(k):
        A = rng.normal(0, 1, (k, 3, 3)).astype(np.float32)
        return (A @ A.transpose(0, 2, 1) * 0.01 + np.eye(3, dtype=np.float32) * 1e-3).astype(np.float32)

    sm, tm = rng.random(N) < 0.95, rng.random(M) < 0.95
    a = 0.02 + 0.01 * seed
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
    T[:3, 3] = [0.03, -0.02, 0.01]
    tgt_q = np.where(tm[:, None], tgt, 1e6).astype(np.float32)
    return T, src, sm, covs(N), tgt_q, tm, covs(M)


_jax_lin = jax.jit(jgicp._linearize, static_argnums=(7, 8))


def _both(N, seed):
    args = _inputs(N, seed)
    y0, H, b, (idx, valid, M, B, sqd) = _jax_lin(*args, 1.0, "auto")
    py0, pH, pb, (pidx, pvalid, pM, pB, _) = gicp._linearize(
        *(torch.from_numpy(np.asarray(x)) for x in args), 1.0, "auto")
    np.testing.assert_array_equal(pidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(valid))
    return (np.asarray(y0), np.asarray(H), np.asarray(b), np.asarray(M)), \
        (py0.numpy(), pH.numpy(), pb.numpy(), pM.numpy())


_H_SPREAD_ULP = 3  # JAX's own 1-core vs 8-core spread of H (see above)


@pytest.mark.parametrize("N,seed", [(512, 0), (512, 1), (1024, 0), (1024, 1),
                                    (2048, 0), (4000, 0), (4096, 0)])
def test_linearize_is_jax_bit_for_bit(N, seed):
    (y0, H, b, M), (py0, pH, pb, pM) = _both(N, seed)
    np.testing.assert_array_equal(pM, M)
    np.testing.assert_array_equal(py0, y0)
    np.testing.assert_array_equal(pb, b)
    if 3 * N < gicp_xla._SHARD_ROWS:
        np.testing.assert_array_equal(pH, H)
    else:
        ulp = np.spacing(np.abs(H).max(axis=1, keepdims=True))
        assert (np.abs(pH.astype(np.float64) - H) / ulp).max() <= _H_SPREAD_ULP


def _align_pair(seed):
    T, src, sm, sc, tgt, tm, tc = _inputs(1024, seed)
    guess = np.eye(4, dtype=np.float32)
    ref = jgicp.align(src, sm, sc, tgt, tm, tc, guess, jgicp.GICPSettings(record_trace=True))
    t = torch.from_numpy
    got = gicp.align(t(src), t(sm), t(sc), t(tgt), t(tm), t(tc), t(guess),
                     gicp.GICPSettings(record_trace=True))
    return ref, got


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_align_trace_is_jax_bit_for_bit(seed):
    ref, got = _align_pair(seed)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(ref.pose_trace), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.final_error.numpy(), np.asarray(ref.final_error), rtol=1e-6)
    np.testing.assert_allclose(got.final_hessian.numpy(), np.asarray(ref.final_hessian), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref.final_hessian)).max())
    assert int(got.num_inliers) == int(ref.num_inliers)


def test_lm_step_pieces_are_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    exp = jax.jit(jse3.se3_exp)
    comp = jax.jit(jse3.compose)
    solve = jax.jit(lambda A, b, lam: jgicp.solve6_ldlt(A + lam * jnp.eye(6, dtype=A.dtype), -b))
    for _ in range(100):
        X = rng.normal(size=(50, 6)).astype(np.float32)
        A, b = (X.T @ X).astype(np.float32), rng.normal(size=6).astype(np.float32)
        lam = np.float32(rng.uniform(1e-3, 1.0))
        d = gicp.solve6_ldlt(torch.from_numpy(A) + torch.tensor(lam) * torch.eye(6),
                             -torch.from_numpy(b), gicp_xla.sub)
        np.testing.assert_array_equal(d.numpy(), np.asarray(solve(A, b, lam)))
        w = (rng.normal(size=6) * 10 ** rng.uniform(-6, -1)).astype(np.float32)
        e = gicp_xla.se3_exp(torch.from_numpy(w))
        np.testing.assert_array_equal(e.numpy(), np.asarray(exp(w)))
        P = np.array(exp((rng.normal(size=6) * 0.1).astype(np.float32)))
        np.testing.assert_array_equal(gicp_xla.compose(e, torch.from_numpy(P)).numpy(),
                                      np.asarray(comp(np.asarray(exp(w)), P)))


@pytest.mark.parametrize("N,seed", [(512, 0), (1024, 1), (4096, 0)])
def test_card_arithmetic_linearize_matches_jax(N, seed):
    """The card's matrix products, run on the host, against jitted JAX."""
    args = _inputs(N, seed)
    y0, H, b, aux = _jax_lin(*args, 1.0, "auto")
    y0, H, b, M = (np.asarray(x) for x in (y0, H, b, aux[2]))
    py0, pH, pb, (_, _, pM, _, _) = gicp._linearize(
        *(torch.from_numpy(np.asarray(x)) for x in args), 1.0, "auto", ar=gicp.TORCH)
    np.testing.assert_allclose(pM.numpy(), M, rtol=1e-5, atol=1e-5 * np.abs(M).max())
    np.testing.assert_allclose(float(py0), float(y0), rtol=1e-5)
    np.testing.assert_allclose(pH.numpy(), H, rtol=0, atol=1e-5 * np.abs(H).max())
    np.testing.assert_allclose(pb.numpy(), b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_card_arithmetic_align_matches_jax(seed, monkeypatch):
    """align with the card's arithmetic (``gicp.TORCH``) on the host: JAX's
    iteration count and pose within 1e-6."""
    monkeypatch.setattr(gicp, "arithmetic", lambda dev: gicp.TORCH)
    ref, got = _align_pair(seed)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.T.numpy(), np.asarray(ref.T), rtol=0, atol=1e-6)
    assert int(got.num_inliers) == int(ref.num_inliers)

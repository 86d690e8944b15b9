"""How close the port's covariance chain comes to the JAX package's on the
CPU, on the scene of tests/golden/linear_32x512_seed7.npz and on
tests/test_kantplatz.py's ``small_kantplatz()`` scene (ROADMAP queue 3).

From identical preprocessed points and k-NN index sets, the port's
neighborhood covariance is bit-identical to the jitted JAX one:
``covariance.neighborhood_covariance`` copies XLA's order (the mean as a
sequential sum times the f32 ``1/k``; the covariance as k sequential fused
multiply-adds, times ``1/k``).

The PLANE regularization of identical covariances is bit-identical too:
``covariance.smallest_eigvec_sym3`` copies where XLA's CPU code generator
contracts a multiply into a fused multiply-add (read from the compiled
fusions' disassembly), flushes denormals as XLA does, takes roots and
quotients correctly rounded, and evaluates glibc's ``cosf`` and
``atan2f`` (which XLA calls for ``cos`` and ``arccos``) op for op. Eager
torch rounding every product, or torch's own ``arccos`` / ``cos`` (up to 2
and 1 ulp from XLA's), moved near-collinear neighborhoods (eigenvalues
~0, 1e-4, 0.8) by up to ~0.99 in one entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_scenes import golden_cfg

from dynamic_direct_lidar_odometry_tpu.odometry import preprocess as jprep
from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov
from dynamic_direct_lidar_odometry_tpu.ops import knn as jknn
from dynamic_direct_lidar_odometry_tpu_torch.io import synthetic
from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess as pprep
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance as pcov
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn as pknn

from torch_parity import port_cfg


def _golden_scan(n=3):
    """The golden scene's scan ``n``, rendered as the golden test renders it."""
    world = synthetic.World.town(seed=7, n_static=10)
    mov = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]),
                         np.array([1.0, 0.3, 0.0]))]
    rng = np.random.default_rng(0)
    out = synthetic.render_scan(world, np.eye(4), H=32, W=512, t=0.0, extra_boxes=mov, rng=rng)
    for i in range(1, n + 1):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.03 * i, 0.0]
        T[0, 0] = T[1, 1] = np.cos(th)
        T[0, 1] = -np.sin(th)
        T[1, 0] = np.sin(th)
        out = synthetic.render_scan(world, T, H=32, W=512, t=0.1 * i, extra_boxes=mov, rng=rng)
    return out


def test_covariance_chain_matches_jax_but_for_fma_contraction():
    jcfg = golden_cfg(organized=True)
    pts, mask = _golden_scan()
    jp = jax.jit(jprep.preprocess, static_argnums=0)(jcfg, jnp.asarray(pts), jnp.asarray(mask))
    pp = pprep.preprocess(port_cfg(jcfg), torch.as_tensor(pts), torch.as_tensor(mask))
    P, M = np.array(jp.points), np.array(jp.mask)
    np.testing.assert_array_equal(pp.points.numpy(), P)
    np.testing.assert_array_equal(pp.mask.numpy(), M)
    assert M.sum() == 405

    k = jcfg.gicp.s2s.k_correspondences
    ji, _ = jknn.knn_best(jnp.asarray(P), jnp.asarray(P), k)
    pi, _ = pknn.knn_best(torch.as_tensor(P), torch.as_tensor(P), k)
    ji = np.array(ji)
    np.testing.assert_array_equal(pi.numpy()[M], ji[M])

    # the neighborhood covariance: bit-identical in XLA's order, not in
    # torch.mean's (a sum divided by k)
    neigh = P[ji][M]

    def jraw(x):
        c = x - jnp.mean(x, axis=1, keepdims=True)
        return jnp.einsum("nki,nkj->nij", c, c, precision=jax.lax.Precision.HIGHEST) / k

    jr = np.array(jax.jit(jraw)(jnp.asarray(neigh)))
    np.testing.assert_array_equal(pcov.neighborhood_covariance(torch.as_tensor(neigh)).numpy(), jr)
    jmean = np.asarray(jax.jit(lambda x: jnp.mean(x, axis=1))(jnp.asarray(neigh)))
    assert (torch.as_tensor(neigh).mean(dim=1).numpy() != jmean).any()

    # XLA divides by a constant as a product with its reciprocal, and
    # contracts a fused multiply-add into one rounding
    x, y, z = (np.random.default_rng(s).standard_normal(4096).astype(np.float32) for s in range(3))
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda v: v / 3.0)(x)), x * np.float32(1.0 / 3.0))
    fma = (x.astype(np.float64) * y + z).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jax.jit(lambda a, b, c: a * b + c)(x, y, z)), fma)
    assert (x * y + z != fma).any()

    # torch's own arccos / cos are not XLA's (glibc's); the port's copies are
    ulp = np.abs(np.asarray(jax.jit(jnp.arccos)(x.clip(-1, 1))).view(np.int32)
                 - torch.arccos(torch.as_tensor(x.clip(-1, 1))).numpy().view(np.int32))
    assert 0 < ulp.max() <= 2
    xc = x.clip(-1, 1)
    sq = np.asarray(jax.jit(lambda v: jnp.sqrt((1 - v) * (1 + v)))(xc))
    np.testing.assert_array_equal(
        pcov._atan2f(torch.from_numpy(sq.copy()), torch.as_tensor(xc)).numpy(),
        np.asarray(jax.jit(jnp.arctan2)(sq, xc)))
    arg = (np.abs(x) % np.float32(1.05) + np.float32(2.09)).astype(np.float32)
    np.testing.assert_array_equal(pcov._cosf(torch.as_tensor(arg)).numpy(),
                                  np.asarray(jax.jit(jnp.cos)(arg)))

    # so identical covariances regularize to the same bits on every row
    jreg = np.asarray(jcov.regularize_plane(jnp.asarray(jr)))
    np.testing.assert_array_equal(pcov.regularize_plane(torch.as_tensor(jr)).numpy(), jreg)


def _kantplatz_scan2():
    """tests/test_kantplatz.py's scene at its third scan (scan 2)."""
    world = synthetic.World.town(seed=11, n_static=8)
    rng = np.random.default_rng(0)
    T = np.eye(4)
    out = synthetic.render_scan(world, T, H=64, W=64, t=0.0, rng=rng)
    for i in range(1, 3):
        T[:3, 3] = [0.08 * i, 0.0, 0.0]
        out = synthetic.render_scan(world, T, H=64, W=64, t=0.1 * i, rng=rng)
    return out


def _scene(name):
    if name == "golden-scan6":
        return golden_cfg(organized=True), _golden_scan(6), None
    from test_kantplatz import small_kantplatz

    return small_kantplatz(), _kantplatz_scan2(), 286


@pytest.mark.parametrize("name", ["golden-scan6", "kantplatz-scan2"])
def test_plane_covariances_bit_equal_to_jax_on_the_scenes(name):
    """The two scenes where the port's PLANE regularization used to leave
    XLA's rounding: the golden's scan 6 (12 rows off by more than 1e-3)
    and the kantplatz scan 2 (55 of 286 rows, up to 0.999). Every valid
    row of ``plane_covariances`` is now bit-equal to the jitted JAX one."""
    jcfg, (pts, mask), n_valid = _scene(name)
    jp = jax.jit(jprep.preprocess, static_argnums=0)(jcfg, jnp.asarray(pts), jnp.asarray(mask))
    P, M = np.array(jp.points), np.array(jp.mask)
    if n_valid is not None:
        assert M.sum() == n_valid
    k = jcfg.gicp.s2s.k_correspondences
    morton = jcfg.preprocessing.voxel_scan.use
    want = np.asarray(jcov.plane_covariances(jp.points, jp.mask, k=k, morton_ordered=morton))
    got = pcov.plane_covariances(torch.as_tensor(P), torch.as_tensor(M), k=k,
                                 morton_ordered=morton).numpy()
    np.testing.assert_array_equal(got[M], want[M])


def test_regularize_plane_bit_equal_on_degenerate_covariances():
    """Near-collinear, near-planar and isotropic neighborhoods, rows with
    denormal-sized entries (XLA flushes them) and exact zeros."""
    rng = np.random.default_rng(5)
    n, k = 3000, 10
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (rng.uniform(-1, 1, (n, k, 1)) * d[:, None] * rng.uniform(0.05, 2, (n, 1, 1))
           + rng.standard_normal((n, k, 3)) * 10.0 ** rng.uniform(-6, 0, (n, 1, 1)))
    c = pts - pts.mean(1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", c, c) / k).astype(np.float32)
    cov[:50] *= np.float32(1e-19)
    cov[50:60] = 0.0
    cov[60:70] = np.eye(3, dtype=np.float32)
    want = np.asarray(jcov.regularize_plane(jnp.asarray(cov)))
    np.testing.assert_array_equal(pcov.regularize_plane(torch.as_tensor(cov)).numpy(), want)

"""How close the port's covariance chain comes to the JAX package's on the
CPU, on the scene of tests/golden/linear_32x512_seed7.npz (ROADMAP queue 3).

From identical preprocessed points and k-NN index sets (scan 3, 405 valid
points), the port's neighborhood covariance is bit-identical to the
jitted JAX one: ``covariance.neighborhood_covariance`` copies XLA's order
(the mean as a sequential sum times the f32 ``1/k``; the covariance as k
sequential fused multiply-adds, times ``1/k``), and ``smallest_eigvec_sym3``
copies XLA's rewrite of a division by a constant into a product with its
reciprocal. With these orders the port reproduces the golden within its
5e-3 bar (tests/test_torch_pipeline_dynamic.py).

What stays different is the PLANE regularization of identical
covariances: XLA's CPU backend contracts the fused elementwise chain's
multiply-adds into FMAs (and its ``arccos`` / ``cos`` differ from torch's by
up to 2 and 1 ulp). Eager torch rounds every product, so most rows differ
in the last bits and a few near-collinear neighborhoods (eigenvalues ~0,
1e-4, 0.8) by up to ~0.9 in one entry, with XLA's ``arccos`` / ``cos``
substituted or not.
"""

import jax
import jax.numpy as jnp
import numpy as np
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


def _scan3():
    """The golden scene's scan 3, rendered as the golden test renders it."""
    world = synthetic.World.town(seed=7, n_static=10)
    mov = [synthetic.Box(np.array([4.0, -2.0, 0.9]), np.array([0.8, 0.8, 1.8]),
                         np.array([1.0, 0.3, 0.0]))]
    rng = np.random.default_rng(0)
    out = synthetic.render_scan(world, np.eye(4), H=32, W=512, t=0.0, extra_boxes=mov, rng=rng)
    for i in range(1, 4):
        th = 0.02 * i
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.03 * i, 0.0]
        T[0, 0] = T[1, 1] = np.cos(th)
        T[0, 1] = -np.sin(th)
        T[1, 0] = np.sin(th)
        out = synthetic.render_scan(world, T, H=32, W=512, t=0.1 * i, extra_boxes=mov, rng=rng)
    return out


def test_covariance_chain_matches_jax_but_for_fma_contraction(monkeypatch):
    jcfg = golden_cfg(organized=True)
    pts, mask = _scan3()
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

    # so identical covariances regularize differently, on a few rows by
    # far more than rounding, with XLA's arccos / cos or torch's
    ulp = np.abs(np.asarray(jax.jit(jnp.arccos)(x.clip(-1, 1))).view(np.int32)
                 - torch.arccos(torch.as_tensor(x.clip(-1, 1))).numpy().view(np.int32))
    assert 0 < ulp.max() <= 2
    jreg = np.asarray(jcov.regularize_plane(jnp.asarray(jr)))

    def rows_off(preg):
        diff = np.abs(jreg - preg).reshape(len(jr), -1).max(axis=1)
        assert diff.max() < 1.0
        return int((diff > 0).sum()), int((diff > 1e-3).sum())

    bits, far = rows_off(pcov.regularize_plane(torch.as_tensor(jr)).numpy())
    assert bits > len(jr) // 2 and 1 <= far <= 40
    for name in ("arccos", "cos"):
        xla = jax.jit(getattr(jnp, name))
        monkeypatch.setattr(torch, name, lambda t, xla=xla: torch.from_numpy(np.array(xla(t.numpy()))))
    bits, far = rows_off(pcov.regularize_plane(torch.as_tensor(jr)).numpy())
    assert bits > len(jr) // 2 and 1 <= far <= 40

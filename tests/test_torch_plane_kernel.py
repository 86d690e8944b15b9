"""The PLANE regularization's kernel module (``ops/covariance.py``, kernel
``csrc/plane_reg.cu``) against the JAX package's jitted
``regularize_plane``.

On the CPU the wrapper runs the kernel's plain version,
``regularize_plane_plain``, which these tests hold bit for bit to JAX:
the Morton-window covariances of a bench scan (the card's main path),
near-collinear, planar and isotropic neighborhoods, denormal-sized and
zero matrices, and rows built so that one of XLA's fused multiply-adds
lands on an f32 midpoint (a cross product's ``fma(a01, a12, -(a02 c11))``
with ``a01 = +-a12 = 1 + 2^-12`` and a tiny ``a02``): the emulation with a
double rounding, which the port had before, misses JAX there, and the
test shows it. The wrapper takes the plain version only for CPU tensors
and raises for any other device that is not CUDA; on the card (``gpu``
marker) the kernel is held to the plain version, as ``chip_smoke.py``
phase 3 does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov
from dynamic_direct_lidar_odometry_tpu_torch import config
from dynamic_direct_lidar_odometry_tpu_torch.core import fp
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build, covariance


def _bits_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per matrix: every entry has the same bits (NaN matching NaN)."""
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    return same.reshape(len(a), -1).all(axis=1)


@functools.lru_cache(maxsize=1)
def _bench_window_covariances() -> np.ndarray:
    """The window path's raw covariances of the bench sequence's scan 0
    (``bench_config()``: 16,384 Morton-ordered rows, k = 10), every row:
    the sentinel rows' too, as the card regularizes them before the mask."""
    cfg = config.bench_config()
    seq = dataset.steady_state_sequence(1)
    p = preprocess.preprocess(cfg, torch.as_tensor(seq.points[0]), torch.as_tensor(seq.mask[0]))
    cov = covariance._window_self_covariances(p.points, cfg.gicp.s2s.k_correspondences)
    return cov.numpy()


def _degenerate(n=3000, seed=5) -> np.ndarray:
    rng = np.random.default_rng(seed)
    k = 10
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (rng.uniform(-1, 1, (n, k, 1)) * d[:, None] * rng.uniform(0.05, 2, (n, 1, 1))
           + rng.standard_normal((n, k, 3)) * 10.0 ** rng.uniform(-6, 0, (n, 1, 1)))
    c = pts - pts.mean(1, keepdims=True)
    cov = (np.einsum("nki,nkj->nij", c, c) / k).astype(np.float32)
    cov[:50] *= np.float32(1e-19)  # denormal-sized entries (XLA flushes them)
    cov[50:60] = 0.0
    cov[60:70] = np.eye(3, dtype=np.float32)  # isotropic: e_z
    cov[70:80] = np.diag([2.0, 2.0, 1.0]).astype(np.float32)  # a double eigenvalue
    return cov


def fma_tie_rows(m=4000, seed=0) -> np.ndarray:
    """Symmetric rows whose cross product c01's first lane,
    ``fma(a01, a12, -ftz(a02 * c11))``, has its product on an f32 midpoint
    (``(1 + 2^-12)^2``) and an addend of 1e-20 |c11| on the product's side
    (``c11 = a11 - lmin >= 0``): the fused result leaves the midpoint, a
    double rounding returns to it and rounds half to even."""
    rng = np.random.default_rng(seed)
    t = np.float32(1 + 2.0**-12)
    d = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    s = np.where(rng.random(m) < 0.5, -1, 1).astype(np.float32)
    a02 = -s * np.float32(1e-20)
    x = np.zeros((m, 3, 3), np.float32)
    x[:, 0, 0], x[:, 1, 1], x[:, 2, 2] = d[:, 0], d[:, 1], d[:, 2]
    x[:, 0, 1] = x[:, 1, 0] = s * t
    x[:, 1, 2] = x[:, 2, 1] = t
    x[:, 0, 2] = x[:, 2, 0] = a02
    return x


def _check_against_jax(cov: np.ndarray):
    want = np.asarray(jcov.regularize_plane(jnp.asarray(cov)))
    got = covariance.regularize_plane_plain(torch.from_numpy(cov)).numpy()
    off = ~_bits_equal(got, want)
    assert not off.any(), f"{off.sum()} of {len(cov)} rows differ from JAX, first {np.nonzero(off)[0][:5]}"


def test_bench_window_covariances_bit_equal_to_jax():
    cov = _bench_window_covariances()
    assert len(cov) == config.bench_config().capacity.max_points
    _check_against_jax(cov)


def test_degenerate_covariances_bit_equal_to_jax():
    _check_against_jax(_degenerate())


def test_fma_tie_rows_bit_equal_to_jax_and_missed_by_double_rounding(monkeypatch):
    cov = fma_tie_rows()
    _check_against_jax(cov)
    want = np.asarray(jcov.regularize_plane(jnp.asarray(cov)))
    # the emulation this repo had before: f64 sum, then f32
    monkeypatch.setattr(fp, "fma32", lambda a, b, c: torch.addcmul(c.double(), a.double(), b.double()).float())
    before = covariance.regularize_plane_plain(torch.from_numpy(cov)).numpy()
    assert (~_bits_equal(before, want)).sum() > len(cov) // 4


def test_wrapper_shape_and_plain_version_on_cpu(monkeypatch):
    """CPU tensors never reach a CUDA build; leading dims are kept."""
    def no_build(*a, **k):
        raise AssertionError("a CUDA build was reached from CPU tensors")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    cov = torch.from_numpy(_degenerate(n=96)).reshape(4, 24, 3, 3)
    out = covariance.regularize_plane(cov)
    assert out.shape == (4, 24, 3, 3)
    torch.testing.assert_close(out.reshape(-1, 3, 3), covariance.regularize_plane_plain(cov.reshape(-1, 3, 3)),
                               rtol=0, atol=0)
    # the spectrum is (1, 1, 1e-3) wherever a normal was found
    ev = torch.linalg.eigvalsh(out.reshape(-1, 3, 3).double())
    torch.testing.assert_close(ev[80:], torch.tensor([1e-3, 1.0, 1.0], dtype=torch.float64).expand(16, 3),
                               rtol=0, atol=1e-6)


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel"):
        covariance.regularize_plane(torch.empty((5, 3, 3), device="meta"))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version on the card and on the host:
    every matrix bit-equal, one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    cov = np.concatenate([_bench_window_covariances(), _degenerate(), fma_tie_rows()])
    card_in = torch.from_numpy(cov).cuda()
    nn_cuda.LAUNCHES.clear()
    got = covariance.regularize_plane(card_in).cpu().numpy()
    assert nn_cuda.LAUNCHES["regularize_plane"] == 1
    plain_card = covariance.regularize_plane_plain(card_in).cpu().numpy()
    host = covariance.regularize_plane_plain(torch.from_numpy(cov)).numpy()
    real = np.isfinite(cov).reshape(len(cov), -1).all(axis=1)
    assert _bits_equal(got, plain_card)[real].all() and _bits_equal(got, host)[real].all()

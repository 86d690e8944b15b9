"""Parity of the port's core and ops modules with the JAX package (CPU).

Tolerances: se3 atol 1e-6 (f32 elementwise math, operation order may
differ); voxel/compact output mask and row order EQUAL, centroids atol
1e-5 (summation order only); preprocess points atol 1e-5 and the median
within 2 ulp (XLA may contract the range's sum of squares); exact NN
sweeps idx equal (k-NN: except on near-ties the f32 distance expansion
cannot order), sqd atol 1e-4; covariances: see each
test (the PLANE normal's own conditioning and the window path's f32
cancellation set the bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, plain_cfg, port_cfg, render_seq, t

from dynamic_direct_lidar_odometry_tpu.core import se3 as jse3
from dynamic_direct_lidar_odometry_tpu.odometry import preprocess as jprep
from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov
from dynamic_direct_lidar_odometry_tpu.ops import filters as jfilters
from dynamic_direct_lidar_odometry_tpu.ops import knn as jknn
from dynamic_direct_lidar_odometry_tpu_torch.core import se3
from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
from dynamic_direct_lidar_odometry_tpu_torch.ops import covariance, filters, knn


def _quats(rng, m=64):
    q = rng.normal(size=(m, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize(
    "name",
    ["skew", "so3_exp_quat", "quat_to_matrix", "matrix_to_quat", "quat_mul",
     "quat_conj", "quat_angle_deg", "se3_exp", "transform_points", "compose"],
)
def test_se3_matches_jax(name):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    v[:4] *= 1e-6  # Taylor branch of so3_exp_quat
    q, q2 = _quats(rng), _quats(rng)
    d = np.concatenate([v, rng.normal(size=(64, 3)).astype(np.float32)], 1)
    Ts = np.asarray(jse3.se3_exp(jnp.asarray(d)))
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(q)))
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    args = {
        "skew": (v,), "so3_exp_quat": (v,), "quat_to_matrix": (q,),
        "matrix_to_quat": (R,), "quat_mul": (q, q2), "quat_conj": (q,),
        "quat_angle_deg": (q,), "se3_exp": (d,),
        "transform_points": (Ts[0], pts), "compose": (Ts[:8], Ts[8:16]),
    }[name]
    want = np.asarray(getattr(jse3, name)(*map(jnp.asarray, args)))
    got = n(getattr(se3, name)(*map(t, args)))
    atol = 1e-4 if name == "quat_angle_deg" else 1e-6  # degrees of |q| ~ 1
    if name == "transform_points":
        atol = 1e-5  # 30 m coordinates: 1 ulp is ~2e-6
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_matrix_to_quat_bits_match_jax():
    """The pose's quaternion (the replay's output and the keyframe test's
    input) rounds as the jitted JAX function: bit for bit, every branch
    of Shepperd's method."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(20000, 4))
    q[:2000, 1:] *= 1e-3  # near the identity
    q[2000:4000, 0] *= 1e-3  # near a half turn
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray((q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32))))
    np.testing.assert_array_equal(n(se3.matrix_to_quat(t(R))), np.asarray(jse3.matrix_to_quat(jnp.asarray(R))))


def _cloud(seed, N=16384, nan_invalid=True):
    """A 32x512-scale cloud: walls, ground and scattered points, ~20 %
    invalid (NaN there, like raw scans)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        rng.uniform(-25, 25, (N // 2, 3)) * [1, 1, 0.05],
        np.column_stack([rng.uniform(-25, 25, N // 4), np.full(N // 4, 7.0),
                         rng.uniform(0, 3, N // 4)]),
        rng.uniform(-25, 25, (N - N // 2 - N // 4, 3)),
    ]).astype(np.float32)
    mask = rng.uniform(size=N) > 0.2
    if nan_invalid:
        pts[~mask] = np.nan
    return pts, mask


@pytest.mark.parametrize("res,capacity", [(0.4, 4096), (0.4, 16384), (1.5, 1024)])
def test_voxel_downsample_matches_jax(res, capacity):
    pts, mask = _cloud(1)
    jp, jm = jfilters.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), res, capacity)
    tp, tm = filters.voxel_downsample(t(pts), t(mask), res, capacity)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    # row order equal: centroids agree row by row up to summation order
    np.testing.assert_allclose(n(tp), np.asarray(jp), atol=1e-5, rtol=0)


@pytest.mark.parametrize("traced", [False, True], ids=["constant_res", "traced_res"])
def test_voxel_binning_rounds_as_jax(traced):
    """Coordinates where ``x / 0.3`` and ``x * (1 / 0.3)`` floor to other
    voxels: with the resolution a compile-time constant XLA multiplies by
    its reciprocal (the preprocess and keyframe filters), with a traced
    one (the map node's leaf size) it divides. Bit for bit either way."""
    rng = np.random.default_rng(9)
    res = np.float32(0.3)
    x = (np.arange(-130, 130) * res).astype(np.float32)  # on the voxel faces
    x = np.concatenate([x + np.float32(u) * np.spacing(x) for u in range(-3, 4)])
    split = np.floor(x / res) != np.floor(x * (np.float32(1) / res))
    edge = x[split][:600]
    assert len(edge) > 40
    pts = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    pts[: len(edge), 0] = edge
    pts[len(edge) : 2 * len(edge), 1] = edge
    mask = rng.uniform(size=4096) > 0.1
    if traced:
        fn = jax.jit(lambda p, m, r: jfilters.voxel_downsample(p, m, r, 4096))
        jp, jm = fn(jnp.asarray(pts), jnp.asarray(mask), jnp.float32(res))
    else:
        jp, jm = jax.jit(lambda p, m: jfilters.voxel_downsample(p, m, 0.3, 4096))(jnp.asarray(pts), jnp.asarray(mask))
    tp, tm = filters.voxel_downsample(t(pts), t(mask), 0.3, 4096, traced=traced)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    other, _ = filters.voxel_downsample(t(pts), t(mask), 0.3, 4096, traced=not traced)
    assert not torch.equal(other, tp)


@pytest.mark.parametrize("capacity", [4096, 20000])
def test_compact_matches_jax(capacity):
    pts, mask = _cloud(2, nan_invalid=False)
    jp, jm = jfilters.compact(jnp.asarray(pts), jnp.asarray(mask), capacity)
    tp, tm = filters.compact(t(pts), t(mask), capacity)
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    np.testing.assert_array_equal(n(tp), np.asarray(jp))


def test_decimate_and_crop_match_jax():
    pts, mask = _cloud(3, N=32 * 512)
    jp, jm = jfilters.decimate(jnp.asarray(pts), jnp.asarray(mask), 32, 512, 1, 4)
    tp, tm = filters.decimate(t(pts), t(mask), 32, 512, 1, 4)
    np.testing.assert_array_equal(n(tp), np.asarray(jp))
    np.testing.assert_array_equal(n(tm), np.asarray(jm))
    np.testing.assert_array_equal(
        n(filters.rowcol_downsample_mask(32, 512, 2, 3)),
        np.asarray(jfilters.rowcol_downsample_mask(32, 512, 2, 3)),
    )
    clean = np.nan_to_num(pts)
    np.testing.assert_array_equal(
        n(filters.crop_box_mask(t(clean), 1.0)),
        np.asarray(jfilters.crop_box_mask(jnp.asarray(clean), 1.0)),
    )


def test_preprocess_matches_jax():
    cfg = plain_cfg()
    _, _, scans = render_seq(cfg, 1)
    pts, mask = scans[0]  # raw scan, NaN in invalid pixels
    jp = jprep.preprocess(cfg, jnp.asarray(pts), jnp.asarray(mask))
    tp = preprocess.preprocess(port_cfg(cfg), t(pts), t(mask))
    np.testing.assert_array_equal(n(tp.mask), np.asarray(jp.mask))
    np.testing.assert_allclose(n(tp.points), np.asarray(jp.points), atol=1e-5, rtol=0)
    # 2 ulp of f32: the range is sqrt(x^2 + y^2 + z^2), XLA's CPU backend
    # may contract the sum of squares into FMAs or not, host by host, and
    # the port takes one fixed order (fma(z, z, fma(y, y, x * x)))
    np.testing.assert_allclose(
        float(tp.spaciousness_median), float(jp.spaciousness_median), rtol=2.4e-7, atol=0
    )
    # what the pipeline consumes of the median: the same keyframe threshold
    assert float(preprocess.adaptive_keyframe_thresh(tp.spaciousness_median)) == float(
        jprep.adaptive_keyframe_thresh(jp.spaciousness_median)
    )
    for s in (3.0, 7.0, 12.0, 25.0):
        assert float(preprocess.adaptive_keyframe_thresh(torch.tensor(s))) == float(
            jprep.adaptive_keyframe_thresh(jnp.float32(s))
        )


def _nn_clouds(seed, Q, T):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    tg = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    tg[::17] = 1.0e6  # sentinel rows
    return q, tg


@pytest.mark.parametrize("Q,T", [(700, 900), (2100, 9000)])
def test_nn1_matches_jax(Q, T):
    q, tg = _nn_clouds(4, Q, T)
    ji, jd = jknn.nn1(jnp.asarray(q), jnp.asarray(tg))
    ti, td = knn.nn1(t(q), t(tg))
    np.testing.assert_array_equal(n(ti), np.asarray(ji))
    np.testing.assert_allclose(n(td), np.asarray(jd), atol=1e-4, rtol=0)


def _gap_after(d64: np.ndarray, k: int) -> np.ndarray:
    """Per row, the gap between the k-th and (k+1)-th smallest exact
    squared distance: the selection runs on the f32 expansion
    ||q||^2 + ||t||^2 - 2 q.t, whose rounding (~1e-4 m^2 at 20-30 m
    coordinates) can order closer ties either way."""
    s = np.sort(d64, axis=1)
    return s[:, k] - s[:, k - 1]


@pytest.mark.parametrize("k", [10, 20])
def test_knn_matches_jax(k):
    q, tg = _nn_clouds(5, 1500, 9000)
    q[:300] = tg[1:301]  # contained queries: their own 0-distance neighbor
    q[:300][np.arange(1, 301) % 17 == 0] = 0.5  # no sentinel queries
    ji, jd = jknn.knn(jnp.asarray(q), jnp.asarray(tg), k)
    ti, td = knn.knn(t(q), t(tg), k)
    ji, ti = np.asarray(ji), n(ti)
    d64 = np.sum((q[:, None, :].astype(np.float64) - tg[None]) ** 2, -1)
    clear = _gap_after(d64, k) > 1e-3
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(ti[clear], ji[clear])
    np.testing.assert_allclose(n(td), np.asarray(jd), atol=1e-4, rtol=0)
    contained = np.arange(1, 301) % 17 != 0
    assert np.all(ti[:300, 0][contained] == np.arange(1, 301)[contained])


def _tie_clouds(case):
    """Clouds whose k-th neighbor is decided by the f32 expansion's
    rounding: 40-50 m from the origin (||q||^2 ~ 2e3: the expansion's
    rounding ~1e-4 m^2), random points ~30 cm apart (the host proves most
    rows from its candidates) or ~5 cm apart (it ranks most rows over
    every target), or a 2 cm lattice (exact ties in the true distance);
    SENTINEL rows in all. The dense clouds and the lattice have rows
    where the plain expansion picks other neighbors."""
    rng = np.random.default_rng(11)
    if case == "lattice":
        g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3)
        tg = (g * 0.02 + np.float32([30.0, -20.0, 2.0])).astype(np.float32)
        q = tg[rng.permutation(len(tg))[:600]] + np.float32(0.01)
    else:
        half = [0.8, 0.8, 0.3] if case == "dense" else [6.0, 6.0, 2.0]
        tg = (rng.uniform(-1, 1, (9000, 3)) * half + [40.0, 25.0, 1.0]).astype(np.float32)
        m = 700 if case == "sparse" else 150
        q = np.concatenate([tg[:m], tg[m:2 * m] + rng.normal(0, 0.03, (m, 3))]).astype(np.float32)
    tg[::13] = 1.0e6
    q[::29] = 1.0e6
    return q, tg


@pytest.mark.parametrize("case", ["sparse", "dense", "lattice"])
@pytest.mark.parametrize("k", [1, 10, 20])
def test_host_sweeps_round_as_jax(case, k, monkeypatch):
    """On the host the exact sweeps select and return what the JAX
    package's jitted sweeps do on the CPU, bit for bit on every row
    (near-ties and SENTINEL rows included)."""
    q, tg = _tie_clouds(case)
    plain = n(knn._sweep(t(q), t(tg), k, 1024, 8192)[1])
    redo = []
    real = knn._select_xla
    monkeypatch.setattr(knn, "_select_xla", lambda *a: redo.append(len(a[0])) or real(*a))
    if k == 1:
        want = jknn.nn1(jnp.asarray(q), jnp.asarray(tg))
        got = knn.nn1(t(q), t(tg))
    else:
        want = jknn.knn(jnp.asarray(q), jnp.asarray(tg), k)
        got = knn.knn(t(q), t(tg), k)
    np.testing.assert_array_equal(n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(n(got[1]), np.asarray(want[1]))
    if case == "sparse":
        assert sum(redo) < 0.05 * len(q)
    else:  # the plain expansion picks other neighbors on some valid row
        valid = (q < 1.0e6).all(1)
        assert (np.sort(plain, 1) != np.sort(n(got[0]).reshape(len(q), -1), 1))[valid].any()
        assert sum(redo) > 0


def _voxel_scan(frame):
    """A rendered 32x512 scan through the JAX preprocess: the Morton-
    ordered voxel cloud the covariances take."""
    cfg = plain_cfg()
    _, _, scans = render_seq(cfg, frame + 1)
    pts, mask = scans[frame]
    p = jprep.preprocess(cfg, jnp.asarray(pts), jnp.asarray(mask))
    return p.points, p.mask


def _well_conditioned(cov: np.ndarray) -> np.ndarray:
    """The PLANE normal is the smallest eigenvector: it is determined to
    ~|dC| / (l2 - l1), so rows with l2 - l1 < 1e-2 l3 (near-collinear
    neighborhoods) have a normal that f32 summation order alone moves."""
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    return (ev[:, 1] - ev[:, 0]) > 1e-2 * np.maximum(ev[:, 2], 1e-12)


@pytest.mark.parametrize("k", [10, 20])
def test_plane_covariances_exact_path_matches_jax(k):
    """Exact k-NN path (the CPU path): the same neighbor sets except on
    near-ties, and on rows with the same set and a well-conditioned
    normal the same regularized covariance to atol 1e-4."""
    jp, jm = _voxel_scan(0)
    P, m = np.asarray(jp), np.asarray(jm)
    want = np.asarray(jcov.plane_covariances(jp, jm, k=k, morton_ordered=True))
    got = n(covariance.plane_covariances(t(jp), t(jm), k=k, morton_ordered=True))
    ji = np.sort(np.asarray(jknn.knn(jp, jp, k)[0]), 1)
    ti = np.sort(n(knn.knn(t(jp), t(jp), k)[0]), 1)
    same = np.all(ji == ti, axis=1)
    d64 = np.sum((P[~same, None, :].astype(np.float64) - P[None]) ** 2, -1)
    assert np.all(_gap_after(d64, k)[m[~same]] < 1e-3)  # only near-ties differ
    neigh = P[ji].astype(np.float64)
    c = neigh - neigh.mean(1, keepdims=True)
    raw = np.einsum("nki,nkj->nij", c, c) / k
    rows = m & same & _well_conditioned(raw)
    assert rows.sum() > 0.85 * m.sum()
    np.testing.assert_allclose(got[rows], want[rows], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[~m], np.broadcast_to(np.eye(3), got[~m].shape))


def _window_gaps(P: np.ndarray, k: int, B: int = 128):
    """Per row of the window path: the f64 gap between the k-th and
    (k+1)-th candidate distance, and |y|^2, the squared distance to the
    block anchor."""
    N = len(P)
    p = np.concatenate([P, np.full(((-N) % B, 3), 3.0e12)]).astype(np.float64)
    q = p.reshape(-1, B, 3)
    c = np.concatenate([np.roll(q, 1, 0), q, np.roll(q, -1, 0)], 1)
    y = q - q[:, :1]
    d2 = np.sum((y[:, :, None] - (c - q[:, :1])[:, None]) ** 2, -1)
    s = np.sort(d2, -1)
    return (s[..., k] - s[..., k - 1]).reshape(-1)[:N], np.sum(y * y, -1).reshape(-1)[:N]


@pytest.mark.parametrize("k", [10, 20])
def test_window_self_covariances_match_jax(k):
    """Morton-window path (the accelerator path) called directly. Its
    block-centered E[yy] - mm subtraction cancels in f32 at the scale of
    |y|^2, the query's squared distance to its block anchor (tens of
    m^2 when a block spans a Morton jump), so the bar is
    1e-5 + 2e-6 |y|^2: ~16 f32 ulps of the moments. Rows whose k-th
    candidate distance is within 1e-3 m^2 of the next may swap that
    neighbor (the weights threshold at the k-th distance) and are left
    out."""
    jp, jm = _voxel_scan(1)
    m = np.asarray(jm)
    want = np.asarray(jcov._window_self_covariances(jp, k))
    got = n(covariance._window_self_covariances(t(jp), k))
    gap, ysq = _window_gaps(np.asarray(jp), k)
    rows = m & (gap > 1e-3)
    assert rows.sum() > 0.9 * m.sum()
    err = np.abs(got - want).max(axis=(1, 2))
    assert np.all(err[rows] <= 1e-5 + 2e-6 * ysq[rows]), err[rows].max()


def test_regularize_plane_matches_jax():
    """Closed-form smallest eigenvector + PLANE spectrum on the same
    covariances: atol 1e-4 where the normal is well conditioned (see
    _well_conditioned: the arccos in Cardano's formula amplifies last-ulp
    differences on near-repeated eigenvalues)."""
    jp, jm = _voxel_scan(2)
    raw = jcov._window_self_covariances(jp, 10)
    rows = np.asarray(jm) & _well_conditioned(np.asarray(raw))
    assert rows.sum() > 0.85 * np.asarray(jm).sum()
    want = np.asarray(jcov.regularize_plane(raw))[rows]
    got = n(covariance.regularize_plane(t(raw)))[rows]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)

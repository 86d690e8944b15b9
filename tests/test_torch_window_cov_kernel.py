"""The Morton-window covariance kernel's module (``ops/covariance.py``
``window_plane_covariances``, kernel ``csrc/plane_reg.cu``
``ddlo_window_plane_cov``) against the JAX package's jitted
``_window_self_covariances`` -> ``regularize_plane`` -> mask.

On the CPU the wrapper runs the kernel's plain version,
``window_plane_covariances_plain``, held here to the jitted JAX function
bit for bit (raw covariances) and with ``test_torch_ops.py``'s bars (raw
covariances within ``1e-5 + 2e-6 |y|^2`` where the k-th and (k+1)-th
candidate distances are more than 1e-3 m^2 apart; regularized ones
within 1e-4 where the normal is well conditioned; identity on masked
rows) on the bench scan at k = 10 and
20, an 8,192-point keyframe cloud, a row count that is no multiple of
128, a whole block of sentinel rows and a cloud whose k-th and (k+1)-th
distances tie exactly. A numpy f32 loop in the documented order (XLA's:
4 accumulators by candidate index mod 4, then ``(a0 + a1) + (a2 + a3)``)
gives the plain version's bits, so the plain version cannot drift from
the order the kernel follows; a numpy model of the kernel's bisection
gives ``torch.topk``'s k-th value. On the card (``gpu`` marker;
this file imports JAX only inside its CPU tests) the kernel is held to
the plain version bit for bit, as ``chip_smoke.py`` phase 3 does.
"""

import functools

import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu_torch import config
from dynamic_direct_lidar_odometry_tpu_torch.core import device
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import SENTINEL
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
from dynamic_direct_lidar_odometry_tpu_torch.odometry import preprocess
from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build, covariance, filters, gicp_xla, nn_cuda

B = covariance.WINDOW_BLOCK
L = 32  # the kernel's lanes a query: candidate j = t L + l in lane l


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Large elementwise passes on a loaded test host: one intra-op
    thread keeps the file from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def _bench_scan():
    """``bench_config()``'s scan 0 of the steady-state sequence through the
    port's preprocess: 16,384 Morton-ordered rows and their mask."""
    cfg = config.bench_config()
    seq = dataset.steady_state_sequence(1)
    p = preprocess.preprocess(cfg, torch.as_tensor(seq.points[0]), torch.as_tensor(seq.mask[0]))
    return p.points.numpy(), p.mask.numpy()


def _cases():
    """(name, points, mask, k): the inputs the kernel's main path and its
    edges give it; the edge cases cut from the scan's first 4,096 rows."""
    pts, msk = _bench_scan()
    kf, kf_m = filters.compact(torch.as_tensor(pts), torch.as_tensor(msk), 8192)
    odd = 4096 - 77
    blank = pts[:4096].copy(), msk[:4096].copy()
    blank[0][5 * B:6 * B], blank[1][5 * B:6 * B] = SENTINEL, False  # a whole block of sentinels
    ties = np.repeat(pts[msk][:1366], 3, axis=0)  # every point three times: the 10th and 11th tie
    return [
        ("bench_k10", pts, msk, 10),
        ("bench_k20", pts, msk, 20),
        ("keyframe_8192", kf.numpy(), kf_m.numpy(), 10),
        ("nonmultiple", pts[:odd], msk[:odd], 10),
        ("sentinel_block", *blank, 10),
        ("ties", ties, np.ones(len(ties), bool), 10),
    ]


def _window_gaps(P: np.ndarray, k: int, rows: np.ndarray):
    """For the given rows: the f64 gap between the k-th and (k+1)-th
    candidate distance, and |y|^2, the squared distance to the block
    anchor."""
    N = len(P)
    p = np.concatenate([P, np.full(((-N) % B, 3), 3.0e12)]).astype(np.float64)
    q = p.reshape(-1, B, 3)
    c = np.concatenate([np.roll(q, 1, 0), q, np.roll(q, -1, 0)], 1)  # (nb, 3B, 3)
    i = np.nonzero(rows)[0]
    y = p[i] - q[i // B, 0]
    d2 = np.sum((y[:, None] - (c[i // B] - q[i // B, :1])) ** 2, -1)
    s = np.sort(d2, -1)
    return s[:, k] - s[:, k - 1], np.sum(y * y, -1)


def _well_conditioned(cov: np.ndarray) -> np.ndarray:
    ev = np.linalg.eigvalsh(cov.astype(np.float64))
    return (ev[:, 1] - ev[:, 0]) > 1e-2 * np.maximum(ev[:, 2], 1e-12)


def _bits_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    same = (a.view(np.int32) == b.view(np.int32)) | (np.isnan(a) & np.isnan(b))
    return same.reshape(len(a), -1).all(axis=1)


CASES = ["bench_k10", "bench_k20", "keyframe_8192", "nonmultiple", "sentinel_block", "ties"]


@functools.lru_cache(maxsize=None)
def _jax_and_plain(case: int):
    """JAX's raw window covariances (jitted, as the pipeline runs them) and
    the plain version's raw and regularized ones (as
    ``window_plane_covariances_plain`` composes them), for one case."""
    import jax
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov

    name, P, M, k = _cases()[case]
    jraw = np.asarray(jax.jit(jcov._window_self_covariances, static_argnums=1)(jnp.asarray(P), k))
    raw = covariance._window_self_covariances(torch.as_tensor(P), k)
    got = torch.where(torch.as_tensor(M)[:, None, None], covariance.regularize_plane_plain(raw), torch.eye(3))
    return jraw, raw.numpy(), got.numpy()


@pytest.mark.parametrize("case", range(6), ids=CASES)
def test_plain_version_matches_jax(case):
    import jax.numpy as jnp

    from dynamic_direct_lidar_odometry_tpu.ops import covariance as jcov

    name, P, M, k = _cases()[case]
    jraw, raw, got = _jax_and_plain(case)
    assert got.shape == (len(P), 3, 3) and np.isfinite(got).all()
    # the raw moments: rows whose k-th neighbor is not a near-tie (exact
    # ties are ties in both: the same set is weighted in)
    gap, ysq = _window_gaps(P, k, M)
    near = (gap > 1e-3) if name != "ties" else np.ones(len(gap), bool)
    assert near.sum() > 0.9 * M.sum()
    err = np.abs(raw - jraw).max(axis=(1, 2))[M]
    assert np.all(err[near] <= 1e-5 + 2e-6 * ysq[near]), err[near].max()
    # the regularization and the mask, against JAX's on the same moments
    want = np.asarray(jnp.where(jnp.asarray(M)[:, None, None], jcov.regularize_plane(jnp.asarray(raw)),
                                jnp.eye(3, dtype=jnp.float32)))
    good = M & _well_conditioned(raw)
    assert good.sum() > 0.85 * M.sum()
    np.testing.assert_allclose(got[good], want[good], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[~M], np.broadcast_to(np.eye(3, dtype=np.float32), got[~M].shape))
    if name == "ties":  # every tie at the k-th distance is weighted in, as topk counts it
        d2 = covariance._window_d2(torch.as_tensor(P))[1].reshape(-1, 3 * B)[: len(P)]
        rk = torch.topk(d2, k, dim=-1, largest=False).values[:, k - 1:]
        assert ((d2 <= rk).sum(-1) > k).double().mean() > 0.9


@pytest.mark.parametrize("case", range(6), ids=CASES)
def test_plain_version_has_jitted_jax_bits(case):
    """Past the bars: the plain version rounds as XLA does on this host
    (its dots' loops, the moments' 4 accumulators, the contracted
    ``mean mean^T``), so every raw covariance is bit-equal to the jitted
    JAX function's."""
    jraw, raw, _ = _jax_and_plain(case)
    off = ~_bits_equal(raw, jraw)
    assert not off.any(), f"{off.sum()} of {len(raw)} rows differ, first {np.nonzero(off)[0][:5]}"


def _plain_d2(P: np.ndarray) -> np.ndarray:
    """d2 in the documented f32 order, (nb, B, 3B)."""
    N = len(P)
    p = np.concatenate([P, np.full(((-N) % B, 3), 3.0e12, np.float32)]).astype(np.float32)
    q = p.reshape(-1, B, 3)
    yc = np.concatenate([np.roll(q, 1, 0), q, np.roll(q, -1, 0)], 1) - q[:, :1]
    cc = _dot3(yc, yc)
    yq, qq = yc[:, B:2 * B, None], cc[:, B:2 * B, None]
    cross = _dot3(yq, yc[:, None])
    return (qq + cc[:, None]) - np.float32(2.0) * cross


def _dot3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """fma(a2, b2, fma(a1, b1, a0 b0)), one rounding each (the numpy
    fused multiply-add of ``ops/gicp_xla``)."""
    return gicp_xla.fma32(a[..., 2], b[..., 2], gicp_xla.fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _numpy_order_model(P: np.ndarray, k: int) -> np.ndarray:
    """The raw covariances, row by row in numpy f32: 4 accumulators by
    candidate index mod 4, each adding its selected candidates in
    ascending order from +0 (skipping the others), then (a0 + a1) + (a2 +
    a3); mean = sum_y / cnt; fma(-mean_a, mean_b, sum_ab / cnt)."""
    N = len(P)
    p = np.concatenate([P, np.full(((-N) % B, 3), 3.0e12, np.float32)]).astype(np.float32)
    q = p.reshape(-1, B, 3)
    yc = np.concatenate([np.roll(q, 1, 0), q, np.roll(q, -1, 0)], 1) - q[:, :1]
    d2 = _plain_d2(P)
    out = np.zeros((q.shape[0] * B, 3, 3), np.float32)
    for b in range(q.shape[0]):
        for i in range(B):
            d = d2[b, i]
            sel = d <= np.sort(d)[k - 1]
            acc = [[np.float32(0.0)] * 9 for _ in range(4)]
            for j in np.nonzero(sel)[0]:
                y = yc[b, j]
                v = [y[0], y[1], y[2], y[0] * y[0], y[0] * y[1], y[0] * y[2],
                     y[1] * y[1], y[1] * y[2], y[2] * y[2]]
                acc[j % 4] = [np.float32(a + x) for a, x in zip(acc[j % 4], v)]
            s = [np.float32(np.float32(a0 + a1) + np.float32(a2 + a3)) for a0, a1, a2, a3 in zip(*acc)]
            cnt = np.float32(max(int(sel.sum()), 1))
            mean = [np.float32(s[a] / cnt) for a in range(3)]
            syy = [[s[3], s[4], s[5]], [s[4], s[6], s[7]], [s[5], s[7], s[8]]]
            for a in range(3):
                for c in range(3):
                    out[b * B + i, a, c] = gicp_xla.fma32(-mean[a], mean[c], np.float32(syy[a][c] / cnt))
    return out[:N]


@pytest.mark.parametrize("k", [10, 3])
def test_plain_version_follows_the_documented_order(k):
    """Bit for bit on 300 rows of the bench scan (three blocks, the last
    one padded), the points doubled so that distances tie."""
    P = np.repeat(_bench_scan()[0][:150], 2, axis=0)
    want = _numpy_order_model(P, k)
    got = covariance._window_self_covariances(torch.as_tensor(P), k).numpy()
    off = ~_bits_equal(got, want)
    assert not off.any(), f"{off.sum()} rows differ, first {np.nonzero(off)[0][:5]}"


def _key(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving key of an f32 (``key_of``)."""
    u = x.astype(np.float32).view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _float(key: np.ndarray) -> np.ndarray:
    """The kernel's ``float_of``."""
    key = key.astype(np.uint32)
    return np.where(key >> 31, key ^ np.uint32(0x80000000), ~key).astype(np.uint32).view(np.float32)


def _count_le(d: np.ndarray, tf: np.ndarray) -> np.ndarray:
    """Per row, 384 minus the sign bits of the f32 ``tf - d``."""
    with np.errstate(invalid="ignore", over="ignore"):
        return d.shape[1] - ((tf[:, None] - d).view(np.uint32) >> 31).sum(axis=1).astype(np.int64)


def _bisect_rk(d: np.ndarray, k: int) -> np.ndarray:
    """A numpy model of the kernel's selection of rk on rows of 384 f32
    distances (lane l holds j = t L + l): the least key T with
    count(key <= T) >= k. Bracket: the float below the least d2, and the
    largest lane minimum (k <= L) or the largest d2; bisection in value
    (at most 10 rounds) while a float lies strictly between, then in key;
    a round that counts exactly k ends it, T then the largest key <= mid."""
    rows = d.shape[0]
    keys = _key(d)
    lane_min = keys.reshape(rows, -1, L).min(axis=1)
    least = np.maximum(keys.min(axis=1), np.uint32(0x00800000))
    vlo = _float(least - np.uint32(1))
    vhi = _float(lane_min.max(axis=1) if k <= L else keys.max(axis=1))
    exact = np.zeros(rows, bool)
    run = np.ones(rows, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(10):
            mid = (vlo + np.float32(0.5) * (vhi - vlo)).astype(np.float32)
            run &= (mid > vlo) & (mid < vhi)
            le = _count_le(d, mid)
            up = run & (le >= k)
            vhi = np.where(up, mid, vhi)
            exact |= up & (le == k)
            vlo = np.where(run & (le < k), mid, vlo)
            run &= ~(up & (le == k))
    lo = _key(vlo).astype(np.uint64) + np.uint64(1)
    hi = _key(vhi).astype(np.uint64)
    while True:
        run = ~exact & (lo < hi)
        if not run.any():
            break
        mid = lo + ((hi - lo) >> np.uint64(1))
        le = _count_le(d, _float(mid.astype(np.uint32)))
        up = run & (le >= k)
        hi = np.where(up, mid, hi)
        exact |= up & (le == k)
        lo = np.where(run & (le < k), mid + np.uint64(1), lo)
    with np.errstate(invalid="ignore"):
        below = ((_float(hi.astype(np.uint32))[:, None] - d).view(np.uint32) >> 31) == 0
    best = np.where(below, keys, np.uint32(0)).max(axis=1)
    return _float(np.where(exact, best, hi.astype(np.uint32)))


@pytest.mark.parametrize("k", [1, 10, 20, 383, 384])
def test_bisection_model_finds_topks_kth_value(k):
    """The kernel's selection, modelled in numpy, gives ``torch.topk``'s
    k-th smallest value bit for bit: on the bench scan's window
    distances, on rows of ties (every value four times; 24 zeros), on
    slightly negative distances, on infinities and on the sentinel
    block's 1e25s."""
    P = _bench_scan()[0][:2048]
    d = covariance._window_d2(torch.as_tensor(P))[1].reshape(-1, 3 * B)
    rng = np.random.default_rng(k)
    ties = np.repeat(rng.uniform(0, 4, (256, 96)).astype(np.float32), 4, axis=1)
    neg = rng.uniform(-1e-6, 1e-6, (256, 3 * B)).astype(np.float32)
    inf = rng.uniform(0, 9, (256, 3 * B)).astype(np.float32)
    inf[:, ::3] = np.inf
    far = np.full((16, 3 * B), 9.0e24, np.float32)
    far[:, :7] = rng.uniform(0, 1, (16, 7))
    zeros = rng.uniform(0, 9, (16, 3 * B)).astype(np.float32)
    zeros[:, rng.permutation(3 * B)[:24]] = 0.0  # the k-th value a tie at 0 for k < 24
    rows = np.concatenate([d.numpy(), ties, neg, inf, far, zeros])
    want = torch.topk(torch.as_tensor(rows), k, dim=-1, largest=False).values[:, k - 1].numpy()
    got = _bisect_rk(rows, k)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_wrapper_takes_the_plain_version_on_cpu(monkeypatch):
    def no_build(*a, **kw):
        raise AssertionError("a CUDA build was reached from CPU tensors")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    P, M = (torch.as_tensor(a[:1000]) for a in _bench_scan())
    got = covariance.window_plane_covariances(P, M, 10)
    torch.testing.assert_close(got, covariance.window_plane_covariances_plain(P, M, 10), rtol=0, atol=0)
    raw = covariance._window_self_covariances(P, 10)
    torch.testing.assert_close(got, torch.where(M[:, None, None], covariance.regularize_plane_plain(raw),
                                                torch.eye(3)), rtol=0, atol=0)
    # plane_covariances on the accelerator branch is the window wrapper,
    # with no regularize_plane of its own; off it, the exact path
    monkeypatch.setattr(device, "on_accelerator", lambda t: True)
    calls = []
    monkeypatch.setattr(covariance, "regularize_plane", lambda c: calls.append(c) or c)
    win = covariance.plane_covariances(P, M, k=10, morton_ordered=True)
    torch.testing.assert_close(win, got, rtol=0, atol=0)
    assert not calls
    covariance.plane_covariances(P, M, k=10, morton_ordered=False)
    assert len(calls) == 1


def test_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel"):
        covariance.window_plane_covariances(torch.empty((256, 3), device="meta"),
                                            torch.empty((256,), dtype=torch.bool, device="meta"), 10)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The kernel against its plain version on the card, every row of every
    case bit-equal; one launch per call, and ``plane_covariances``' window
    branch launches it once and ``regularize_plane`` not at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    for name, P, M, k in _cases():
        p, m = torch.as_tensor(P).cuda(), torch.as_tensor(M).cuda()
        nn_cuda.LAUNCHES.clear()
        got = covariance.window_plane_covariances(p, m, k).cpu().numpy()
        assert nn_cuda.LAUNCHES["window_plane_cov"] == 1, name
        plain = covariance.window_plane_covariances_plain(p, m, k).cpu().numpy()
        assert _bits_equal(got, plain).all(), (name, int((~_bits_equal(got, plain)).sum()))
    nn_cuda.LAUNCHES.clear()
    covariance.plane_covariances(p, m, k=10, morton_ordered=True)
    torch.cuda.synchronize()
    assert nn_cuda.LAUNCHES["window_plane_cov"] == 1 and nn_cuda.LAUNCHES["regularize_plane"] == 0


def _accuracy_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools", "torch_accuracy.py")
    spec = importlib.util.spec_from_file_location("torch_accuracy", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path, launches, ok", [
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "jv_solve": 5, "window_plane_cov": 7}, True),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "jv_solve": 5, "window_plane_cov": 5,
                "regularize_plane": 2}, True),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "jv_solve": 5, "window_plane_cov": 6}, False),
    ("sparse", {"nn1_sparse": 30, "nn1_key_fill": 30, "jv_solve": 5, "window_plane_cov": 7,
                "regularize_plane": 1}, False),
    ("none", {"window_plane_cov": 7}, None),  # on the host nothing launches
])
def test_accuracy_launch_check_counts_both_covariance_kernels(path, launches, ok):
    """On the card a covariance call launches ``window_plane_cov`` (the
    window path) or ``regularize_plane`` (the exact path), one of them."""
    acc = _accuracy_tool()
    if ok is None:
        assert not acc.launch_check(path, launches, linearizations=30, covariance_calls=7)
    else:
        assert acc.launch_check(path, launches, linearizations=30, covariance_calls=7, tracker_updates=5) is ok

"""The lane-class k-NN (``nn_cuda.knn_approx``) against the JAX Pallas
kernels (``knn_approx_pallas``, dense and with ``prune_radius``).

On the CPU the port's wrapper runs the kernels' plain version
(``knn_classes_reference``); the JAX side runs Pallas in interpret mode.
The function is the TPU kernel's lane-class approximation, not an exact
k-NN. Bars: index equal on every row and rank; squared distance within
atol 1e-4 plus rtol 1e-6 (a few f32 ulps, as tests/test_torch_nn_dense.py
explains); the pruned variant's CSR lists equal the JAX ones. The CUDA
kernels are held bit for bit against the plain version on the card
(``gpu`` marker here, phase 3 of chip_smoke.py).

What the CUDA kernel's design relies on is held here on the CPU by a numpy
model of its sweep (:func:`_kernel_model`), bit for bit against
``knn_classes_reference`` on inputs with ties: lane l owns classes 4l ..
4l+3; a carry takes the minimum of the distance bits over a batch of up
to 8 units of 128 rows and keeps the batch that last lowered it, not an
index; each lane orders its 4 classes by distance bits, and a top-k round
is the minimum of the lanes' heads, then the lowest lane that holds it;
the index is found afterwards as the lowest unit of the winner's batch at
the winning distance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.ops import nn_pallas
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import knn, nn_cuda


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _cloud(Q, seed=0, lo=-20.0, hi=20.0):
    return np.random.default_rng(seed).uniform(lo, hi, (Q, 3)).astype(np.float32)


def _class_ties():
    """Integer points repeated so equal distances fall in different
    classes: ties go to the lower class."""
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(4), indexing="ij"), -1)
    tg = np.tile(g.reshape(-1, 3).astype(np.float32), (5, 1))  # 320 rows
    q = (g.reshape(-1, 3)[::5] + 0.5).astype(np.float32)
    return q, tg


def _sentinels():
    q, tg = _cloud(301, seed=3), _cloud(517, seed=4)
    q[::11] = 1.0e6
    tg[::12] = 1.0e6
    return q, tg


CASES = {
    # name: (query, target, k, q_tile, t_chunk); the first two are the
    # cases of tests/test_nn_pallas.py (a cloud against itself)
    "self_512_k10": (_cloud(512), _cloud(512), 10, 128, 128),
    "self_384_k8": (_cloud(384, seed=3), _cloud(384, seed=3), 8, 128, 128),
    "t_below_128_empty_classes": (_cloud(200, seed=5), _cloud(90, seed=6), 20, 128, 128),
    "k128": (_cloud(300, seed=7), _cloud(700, seed=8), 128, 128, 128),
    "class_ties": (*_class_ties(), 10, 128, 128),
    "sentinels_nonmultiple": (*_sentinels(), 10, 128, 256),
    "default_tiles": (_cloud(1500, seed=9), _cloud(1500, seed=9), 10, 1024, 512),
}


@pytest.mark.parametrize("prune", [None, 5.0], ids=["dense", "pruned_r5"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_knn_classes_matches_pallas(case, prune):
    q, tg, k, q_tile, t_chunk = CASES[case]
    ij, dj = (np.asarray(x) for x in nn_pallas.knn_approx_pallas(
        jnp.asarray(q), jnp.asarray(tg), k, q_tile=q_tile, t_chunk=t_chunk, prune_radius=prune
    ))
    it, dt = (n(x) for x in nn_cuda.knn_approx(t(q), t(tg), k, q_tile, t_chunk, prune_radius=prune))
    assert it.shape == (len(q), k) and it.dtype == np.int32 and dt.dtype == np.float32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_class_chunk_lists_match_jax(case):
    q, tg, k, q_tile, t_chunk = CASES[case]
    r = 5.0
    qp, tp = pad_rows(t(q), q_tile, 0.0), pad_rows(t(tg), t_chunk, 1.0e6)
    counts, lists = nn_cuda.class_chunk_lists(qp, tp, r, q_tile, t_chunk)
    # the JAX overlap test, as knn_approx_pallas builds it (every padded
    # query row in the tile box, sentinels included)
    qb = jnp.asarray(n(qp)).reshape(-1, q_tile, 3)
    tb = jnp.asarray(n(tp)).reshape(-1, t_chunk, 3)
    overlap = jnp.all(
        (qb.min(axis=1)[:, None, :] - r <= tb.max(axis=1)[None])
        & (qb.max(axis=1)[:, None, :] + r >= tb.min(axis=1)[None]),
        axis=-1,
    )
    jc, jl = nn_pallas._sparse_chunk_lists(overlap)
    np.testing.assert_array_equal(n(counts), np.asarray(jc))
    np.testing.assert_array_equal(n(lists), np.asarray(jl))


def test_edge_semantics():
    """An empty class keeps (3e12, 0); the index is clamped to the target."""
    q, tg = _cloud(10, seed=1), _cloud(5, seed=2)
    idx, d = nn_cuda.knn_approx(t(q), t(tg), 8, q_tile=128, t_chunk=128)
    # 5 real rows + 123 padding rows at 1e6 (distance ~3e12, which loses
    # to the carry only where it rounds to >= 3e12): ranks 5.. are padding
    # or empty classes, all clamped into the target
    assert torch.all(idx < 5) and torch.all(d[:, :5] < 1e4) and torch.all(d[:, 5:] > 1e12)


def test_knn_best_takes_the_class_kernel_on_the_accelerator(monkeypatch):
    from dynamic_direct_lidar_odometry_tpu_torch.core import device

    q = _cloud(300, seed=4)
    monkeypatch.setattr(device, "on_accelerator", lambda x: True)
    calls = []
    real = nn_cuda.knn_classes_chunks
    monkeypatch.setattr(nn_cuda, "knn_classes_chunks", lambda *a: calls.append(1) or real(*a))
    knn.knn_best(t(q), t(q), 10)
    assert calls == [1]
    monkeypatch.setenv("DDLO_KNN_IMPL", "exact")
    knn.knn_best(t(q), t(q), 10)
    assert calls == [1]  # the exact sweep


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(nn_cuda, "build", no_build)
    q = _cloud(300, seed=9)
    nn_cuda.knn_approx(t(q), t(q), 10)
    nn_cuda.knn_approx(t(q), t(q), 10, prune_radius=5.0)
    assert nn_cuda.LAUNCHES["knn_classes"] == nn_cuda.LAUNCHES["knn_classes_sparse"] == 0
    with pytest.raises(ValueError, match="k <= 128"):
        nn_cuda.knn_approx(t(q), t(q), 129)


@pytest.mark.gpu
@pytest.mark.parametrize("prune", [None, 5.0], ids=["dense", "pruned_r5"])
def test_cuda_kernel_matches_plain_version(prune):
    """The hand-written kernels against their plain version on the card:
    identical index and distance on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    dev = torch.device("cuda")
    q = pad_rows(t(_cloud(5000, seed=11)).to(dev), 1024, 0.0).contiguous()
    tp = pad_rows(t(_cloud(9000, seed=12)).to(dev), 512, 1.0e6)
    counts = lists = None
    if prune is not None:
        counts, lists = nn_cuda.class_chunk_lists(q, tp, prune, 1024, 512)
    args = (q, tp.T.contiguous(), counts, lists, 1024, 512, 10)
    ik, dk = nn_cuda.knn_classes_chunks(*args)
    ir, dr = nn_cuda.knn_classes_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(ik, ir) and torch.equal(dk, dr)


BIG = np.float32(3.0e12)
TAKEN = np.uint32(0xFFFFFFFF)
UNIT, UNITS = 128, 8  # csrc/knn_classes.cu: rows per unit, units per batch


def _dist(q, tx, ty, tz):
    """((dx*dx + dy*dy) + dz*dz) in f32, every operation rounded."""
    dx, dy, dz = q[:, 0:1] - tx, q[:, 1:2] - ty, q[:, 2:3] - tz
    return (dx * dx + dy * dy) + dz * dz


def _bit_rounds(key, k):
    """k rounds of the kernel's epilogue over (rows, 32 lanes, 4 slots)
    uint32 keys (distance bits; class = 4 * lane + slot). Each lane
    orders its 4 slots ascending, equal keys in slot order; a round takes
    the minimum of the lanes' heads, then the lowest lane that holds it,
    and that lane pops its head. Returns (bits, class), each (rows, k)."""
    rows = np.arange(key.shape[0])
    order = np.argsort(key, axis=2, kind="stable")
    srt = np.take_along_axis(key, order, axis=2)
    srt = np.concatenate([srt, np.full(srt.shape[:2] + (1,), TAKEN)], axis=2)  # an emptied lane
    head = np.zeros(key.shape[:2], np.int64)
    out_b = np.zeros((key.shape[0], k), np.uint32)
    out_c = np.zeros((key.shape[0], k), np.int64)
    for r in range(k):
        lm = np.take_along_axis(srt, head[:, :, None], axis=2)[:, :, 0]
        gm = lm.min(axis=1)
        owner = np.argmax(lm == gm[:, None], axis=1)  # the lowest lane at the minimum
        out_b[:, r] = gm
        out_c[:, r] = 4 * owner + order[rows, owner, head[rows, owner]]
        head[rows, owner] += 1
    return out_b, out_c


def _kernel_model(q, tt, counts, lists, q_tile, t_chunk, k):
    """numpy model of csrc/knn_classes.cu, tile by tile (a tile's query
    groups all sweep the same units)."""
    q, tt = q.numpy(), tt.numpy()
    Qp, Tp = q.shape[0], tt.shape[1]
    per_chunk = t_chunk // UNIT
    out_i = np.zeros((Qp, k), np.int32)
    out_d = np.zeros((Qp, k), np.float32)
    for i in range(Qp // q_tile):
        chunks = range(Tp // t_chunk) if counts is None else lists[i, : int(counts[i])].tolist()
        bases = [c * t_chunk + j * UNIT for c in chunks for j in range(per_chunk)]
        qt = q[i * q_tile : (i + 1) * q_tile]
        bd = np.full((q_tile, UNIT), BIG, np.float32)
        bb = np.full((q_tile, UNIT), -1, np.int64)
        for b in range(0, len(bases), UNITS):
            m = None
            for base in bases[b : b + UNITS]:  # the last batch may hold fewer units
                d = _dist(qt, *(tt[c, base : base + UNIT] for c in range(3)))
                m = d if m is None else np.minimum(m, d)
            lower = m < bd
            bd, bb = np.where(lower, m, bd), np.where(lower, b // UNITS, bb)
        bits, cls = _bit_rounds(bd.view(np.uint32).reshape(q_tile, 32, 4), k)
        dist = bits.view(np.float32)
        batch = np.take_along_axis(bb, cls, axis=1)
        idx = np.zeros((q_tile, k), np.int64)
        for g in reversed(range(UNITS)):  # the lowest unit at the winning distance wins
            for r in range(k):
                u = batch[:, r] * UNITS + g
                ok = (batch[:, r] >= 0) & (u < len(bases))
                row = np.asarray(bases + [0])[np.where(ok, u, len(bases))] + cls[:, r]
                dd = _dist(qt, tt[0, row][:, None], tt[1, row][:, None], tt[2, row][:, None])[:, 0]
                idx[:, r] = np.where(ok & (dd == dist[:, r]), row, idx[:, r])
        out_i[i * q_tile : (i + 1) * q_tile] = idx
        out_d[i * q_tile : (i + 1) * q_tile] = dist
    return torch.from_numpy(out_i), torch.from_numpy(out_d)


def _tie_case(seed, n_q, n_t, t_chunk, q_tile=128):
    """Integer-valued targets drawn from 40 points, so every query meets
    equal distances inside a class, across classes, across the units of
    a batch and across batches; some sentinel rows on both sides; tile 1
    of the pruned lists is empty when there is one."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, (40, 3)).astype(np.float32)
    tg = base[rng.integers(0, 40, n_t)]
    tg[rng.uniform(size=n_t) < 0.05] = 1.0e6
    qr = base[rng.integers(0, 40, n_q)] + rng.integers(0, 2, (n_q, 3)).astype(np.float32) * 0.5
    qr[::37] = 1.0e6
    qp = pad_rows(t(qr), q_tile, 0.0).contiguous()
    tp = pad_rows(t(tg), t_chunk, 1.0e6)
    counts, lists = nn_cuda.class_chunk_lists(qp, tp, 1.0, q_tile, t_chunk)
    if counts.shape[0] > 1:
        counts[1] = 0
    return qp, tp.T.contiguous(), counts, lists


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("t_chunk,n_t,k", [(512, 2048, 10), (128, 900, 20), (384, 1000, 128), (256, 300, 1)])
def test_kernel_model_equals_plain_version_on_ties(t_chunk, n_t, k, sparse):
    qp, tt, counts, lists = _tie_case(k, 300, n_t, t_chunk)
    if not sparse:
        counts = lists = None
    want = nn_cuda.knn_classes_reference(qp, tt, counts, lists, 128, t_chunk, k)
    got = _kernel_model(qp, tt, counts, lists, 128, t_chunk, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if sparse:  # the empty list: every class keeps (3e12, 0)
        assert torch.all(want[0][128:256] == 0) and torch.all(want[1][128:256] == float(BIG))
    else:  # ties were met: some winning distance repeats within a row
        assert bool((want[1][:, 1:] == want[1][:, :-1]).any()) or k == 1


@settings(max_examples=12, deadline=None, derandomize=True)
@given(seed=st.integers(0, 5), units=st.integers(1, 11), t_chunk=st.sampled_from([128, 256, 384, 512]),
       k=st.integers(1, 128), sparse=st.booleans())
def test_kernel_model_equals_plain_version_any_shape(seed, units, t_chunk, k, sparse):
    qp, tt, counts, lists = _tie_case(seed, 150, units * 128 - 17, t_chunk)
    if not sparse:
        counts = lists = None
    want = nn_cuda.knn_classes_reference(qp, tt, counts, lists, 128, t_chunk, k)
    got = _kernel_model(qp, tt, counts, lists, 128, t_chunk, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 1000), k=st.integers(1, 128), levels=st.integers(1, 200))
def test_bit_ordered_rounds_equal_a_stable_ascending_sort(seed, k, levels):
    """For d >= +0 the float's bits order as the float, so k rounds of
    (minimum of the bits, then lowest class) are the first k of a stable
    ascending sort of the 128 class minima: lax.top_k's tie rule."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([[0.0, 1e-30, float(BIG)], rng.uniform(0, 50, levels)]).astype(np.float32)
    d = pool[rng.integers(0, len(pool), (8, 128))]
    bits, cls = _bit_rounds(d.view(np.uint32).reshape(8, 32, 4), k)
    sd, pos = torch.sort(torch.from_numpy(d), dim=1, stable=True)
    np.testing.assert_array_equal(bits.view(np.float32), sd[:, :k].numpy())
    np.testing.assert_array_equal(cls, pos[:, :k].numpy())

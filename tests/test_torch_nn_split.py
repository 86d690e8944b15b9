"""The merge rule behind the 1-NN kernels' split sweep (csrc/nn1_sparse.cu).

The kernels cut each query block's sweep into contiguous runs of target
columns, sweep the runs in parallel, and merge the partial (d, j) pairs
with the minimum of the packed key ``(bits(d) << 32) | j`` from the
initial key (3e12, 0) (``nn_cuda.KEY_INIT``), reading (idx, d) back as
the key's halves (``nn_cuda.unpack_keys``). Here, on the CPU, the plain
versions' arithmetic over arbitrary contiguous runs, merged that way,
must equal the unsplit plain version on every row, bit for bit: the
sparse case with each tile's chunk list cut anywhere (inside chunks
too), the dense case with the target cut anywhere. Inputs (numpy, from
a seed) force ties across run boundaries (every target point appears
in several chunks), and include all-sentinel rows, a tile with no
active chunk and rows out of radius.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

BIG = 3.0e12
Q_TILE, T_CHUNK = 128, 128


def _clouds(seed):
    """Queries over 4 tiles (tile 2 all sentinel, so it sweeps nothing;
    some far rows out of radius) and a target whose 256 points each
    appear three times, in other chunks (rows i, i + 256, i + 576), with
    a block of sentinel targets between the copies."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-10, 10, (256, 3)).astype(np.float32)
    tg = np.concatenate([base, base, np.full((64, 3), 1.0e6, np.float32), base])
    q = (base[rng.integers(0, 256, 4 * Q_TILE)] + rng.normal(0, 0.3, (4 * Q_TILE, 3))).astype(np.float32)
    q[2 * Q_TILE : 3 * Q_TILE] = 1.0e6
    q[::29] += np.float32(25.0)  # out of radius
    q[5::41] = 1.0e6
    return q, tg


def _pack(idx, d):
    d = np.ascontiguousarray(d, np.float32)
    return (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | idx.astype(np.uint32).astype(np.uint64)


def _partial(qt, tt, cols):
    """The plain versions' arithmetic over one run of ascending columns:
    first minimum of d, (3e12, 0) unless strictly below 3e12."""
    if cols.numel() == 0:
        return np.zeros(qt.shape[0], np.int64), np.full(qt.shape[0], BIG, np.float32)
    t = tt[:, cols]
    dx, dy, dz = qt[:, 0:1] - t[0], qt[:, 1:2] - t[1], qt[:, 2:3] - t[2]
    d = dx * dx + dy * dy + dz * dz
    am = torch.argmin(d, dim=1)
    dm = torch.gather(d, 1, am[:, None])[:, 0]
    take = dm < BIG
    return torch.where(take, cols[am], 0).numpy(), torch.where(take, dm, BIG).numpy()


def _merge(parts, rows):
    keys = np.full(rows, nn_cuda.KEY_INIT, np.uint64)
    for idx, d in parts:
        keys = np.minimum(keys, _pack(idx, d))
    return nn_cuda.unpack_keys(torch.from_numpy(keys.view(np.int64)))


def _runs(n, cuts):
    """Contiguous runs of range(n) at the given cut points."""
    edges = [0] + sorted({c for c in cuts if 0 < c < n}) + [n]
    return [(a, b) for a, b in zip(edges[:-1], edges[1:])]


def _sparse_case(seed, radius=2.0):
    q, tg = _clouds(seed)
    prep = nn_cuda.prepare_sparse_target(torch.from_numpy(tg), T_CHUNK)
    qp = pad_rows(torch.from_numpy(q), Q_TILE, 1.0e6).contiguous()
    counts, lists = nn_cuda.tile_chunk_lists(qp, prep, radius, Q_TILE)
    return qp, prep.tt, counts, lists


def _sparse_split(qp, tt, counts, lists, cuts_of_tile):
    idx = np.zeros(qp.shape[0], np.int32)
    dist = np.zeros(qp.shape[0], np.float32)
    ar = torch.arange(T_CHUNK)
    for i, c in enumerate(counts.tolist()):
        cols = (lists[i, :c, None].long() * T_CHUNK + ar).reshape(-1)
        qt = qp[i * Q_TILE : (i + 1) * Q_TILE]
        parts = [_partial(qt, tt, cols[a:b]) for a, b in _runs(cols.numel(), cuts_of_tile(i, cols.numel()))]
        ti, td = _merge(parts, Q_TILE)
        idx[i * Q_TILE : (i + 1) * Q_TILE] = ti.numpy()
        dist[i * Q_TILE : (i + 1) * Q_TILE] = td.numpy()
    return torch.from_numpy(idx), torch.from_numpy(dist)


def _assert_identical(got, want):
    (gi, gd), (wi, wd) = got, want
    assert torch.equal(gi, wi.to(gi.dtype)), "index differs"
    assert torch.equal(gd, wd), "distance differs"


def test_inputs_cover_the_edge_cases():
    qp, tt, counts, lists = _sparse_case(0)
    ir, dr = nn_cuda.nn1_sparse_reference(qp, tt, counts, lists, Q_TILE, T_CHUNK)
    assert int(counts[2]) == 0 and torch.all(dr[2 * Q_TILE : 3 * Q_TILE] == BIG)
    assert int(counts.max()) >= 3
    assert bool((dr[: 2 * Q_TILE] >= 4.0).any()) and bool((dr[: 2 * Q_TILE] < 4.0).any())
    # ties: every real winner has exact copies in other chunks
    win = tt[:, ir[dr < 4.0].long()]
    copies = (tt[:, None, :] == win[:, :, None]).all(dim=0).sum(dim=1)
    assert int(copies.min()) == 3


@pytest.mark.parametrize("split", ["stage", "chunk", "one_per_pair", "uneven"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_split_merge_equals_unsplit(seed, split):
    qp, tt, counts, lists = _sparse_case(seed)
    cuts = {
        "stage": lambda i, n: range(0, n, 32),  # sub-chunk runs, as the kernel's stage units
        "chunk": lambda i, n: range(0, n, T_CHUNK),
        "one_per_pair": lambda i, n: range(n),
        "uneven": lambda i, n: [1, 77, 200, 256, 257, n - 3],
    }[split]
    want = nn_cuda.nn1_sparse_reference(qp, tt, counts, lists, Q_TILE, T_CHUNK)
    _assert_identical(_sparse_split(qp, tt, counts, lists, cuts), want)


@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(0, 3), cuts=st.lists(st.integers(0, 1024), max_size=12))
def test_sparse_split_merge_any_cuts(seed, cuts):
    qp, tt, counts, lists = _sparse_case(seed, radius=3.0)
    want = nn_cuda.nn1_sparse_reference(qp, tt, counts, lists, Q_TILE, T_CHUNK)
    _assert_identical(_sparse_split(qp, tt, counts, lists, lambda i, n: cuts), want)


@settings(max_examples=15, deadline=None, derandomize=True)
@given(seed=st.integers(0, 3), cuts=st.lists(st.integers(0, 768), max_size=10))
def test_dense_split_merge_equals_unsplit(seed, cuts):
    q, tg = _clouds(seed)
    qp = pad_rows(torch.from_numpy(q), Q_TILE, 0.0).contiguous()
    tt = pad_rows(torch.from_numpy(tg), T_CHUNK, 1.0e6).T.contiguous()
    cols = torch.arange(tt.shape[1])
    parts = [_partial(qp, tt, cols[a:b]) for a, b in _runs(cols.numel(), cuts)]
    _assert_identical(_merge(parts, qp.shape[0]), nn_cuda.nn1_dense_reference(qp, tt))


def test_key_order_is_the_sweep_order():
    """Bits of d >= +0 order as the floats; a lower index wins a tie; the
    initial key unpacks to (0, 3e12) and beats a pair at exactly 3e12."""
    d = np.array([0.0, 1e-30, 0.5, 0.5, 3.0e12, 3.0e12, 4.0e12, 1e6**2 * 3], np.float32)
    j = np.array([9, 3, 7, 2, 0, 5, 1, 8])
    keys = _pack(j, d)
    order = np.lexsort((j, d))
    assert np.array_equal(np.argsort(keys, kind="stable"), order)
    idx, dist = nn_cuda.unpack_keys(torch.full((3,), nn_cuda.KEY_INIT, dtype=torch.int64))
    assert torch.all(idx == 0) and torch.all(dist == BIG)
    assert nn_cuda.KEY_INIT < int(_pack(np.array([5]), np.array([BIG], np.float32))[0])


@pytest.mark.parametrize("units", [1, 3, 88, 512, 200000])
@pytest.mark.parametrize("resident", [132, 2112, 4224])
def test_splits_stay_in_range(units, resident):
    """The grid's y extent (nn_cuda.nn1_splits, static shapes only): at
    least one split, at most one per unit and the grid's y limit."""
    splits = nn_cuda.nn1_splits(units, 64, resident)
    assert 1 <= splits <= min(units, 65535)

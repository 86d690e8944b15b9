"""The sparse 1-NN module (ops/nn_cuda.py) against the JAX Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version
(``nn1_sparse_reference``); the JAX side runs ``nn1_sparse_pallas`` in
Pallas interpret mode, on the cases of tests/test_nn_pallas.py. Bars:
index equal on every in-radius query (true NN within r), squared
distance atol 1e-4 there, out-of-radius queries >= r^2 in both; the CSR
chunk lists equal to ``_sparse_chunk_lists``. The CUDA kernel itself is
checked against the plain version on the card (``gpu`` marker here, and
phase 3 of chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import n, t

from dynamic_direct_lidar_odometry_tpu.ops import knn as jknn
from dynamic_direct_lidar_odometry_tpu.ops import nn_pallas
from dynamic_direct_lidar_odometry_tpu_torch.core.cloud import pad_rows
from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda


@pytest.fixture(autouse=True)
def _interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        yield


def _clouds(Q=700, T=900, seed=0, sentinel_every=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    tg = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    if sentinel_every:
        q[::sentinel_every] = 1.0e6
        tg[:: sentinel_every + 1] = 1.0e6
    return q, tg


def _sorted_clouds():
    rng = np.random.default_rng(5)
    tg = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    tg = tg[np.argsort((tg[:, 0] // 2.0) * 1000 + tg[:, 1] // 2.0)]
    q = (tg[::3] + rng.normal(0, 0.2, (len(tg[::3]), 3))).astype(np.float32)
    return q, tg


CASES = {
    # name: (query, target, radius, q_tile, t_chunk)
    "random": (*_clouds(700, 900, seed=2), 5.0, 128, 128),
    "morton_sorted": (*_sorted_clouds(), 1.0, 256, 256),
    "sentinels_nonmultiple": (*_clouds(301, 517, seed=3, sentinel_every=11), 8.0, 128, 256),
    "default_tiles": (*_clouds(2500, 3000, seed=4, sentinel_every=7), 3.0, 1024, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn1_sparse_matches_pallas(case):
    q, tg, r, q_tile, t_chunk = CASES[case]
    i0, d0 = (np.asarray(x) for x in jknn.nn1(jnp.asarray(q), jnp.asarray(tg)))
    ij, dj = (np.asarray(x) for x in nn_pallas.nn1_sparse_pallas(
        jnp.asarray(q), jnp.asarray(tg), radius=r, q_tile=q_tile, t_chunk=t_chunk
    ))
    it, dt = (n(x) for x in nn_cuda.nn1_sparse(t(q), t(tg), r, q_tile, t_chunk))
    in_range = d0 < r * r
    assert in_range.sum() > 50
    np.testing.assert_array_equal(it[in_range], ij[in_range])
    np.testing.assert_array_equal(it[in_range], i0[in_range])
    np.testing.assert_allclose(dt[in_range], dj[in_range], atol=1e-4, rtol=0)
    assert np.all(dt[~in_range] >= r * r)
    assert np.all(dj[~in_range] >= r * r)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_chunk_lists_match_jax(case):
    q, tg, r, q_tile, t_chunk = CASES[case]
    prep = nn_cuda.prepare_sparse_target(t(tg), t_chunk)
    jprep = nn_pallas.prepare_sparse_target(jnp.asarray(tg), t_chunk)
    np.testing.assert_array_equal(n(prep.tt), np.asarray(jprep.tt))
    np.testing.assert_array_equal(n(prep.t_lo), np.asarray(jprep.t_lo))
    np.testing.assert_array_equal(n(prep.t_hi), np.asarray(jprep.t_hi))
    qp = pad_rows(t(q), q_tile, 1.0e6)
    counts, lists = nn_cuda.tile_chunk_lists(qp, prep, r, q_tile)
    # the JAX overlap test, as nn1_sparse_prepared builds it
    qb = jnp.asarray(n(qp)).reshape(-1, q_tile, 3)
    real = jnp.all(qb < 5.0e5, axis=-1, keepdims=True)
    lo = jnp.min(jnp.where(real, qb, jnp.inf), axis=1)
    hi = jnp.max(jnp.where(real, qb, -jnp.inf), axis=1)
    overlap = jnp.all(
        (lo[:, None, :] - r <= jprep.t_hi[None]) & (hi[:, None, :] + r >= jprep.t_lo[None]),
        axis=-1,
    )
    jc, jl = nn_pallas._sparse_chunk_lists(overlap)
    np.testing.assert_array_equal(n(counts), np.asarray(jc))
    np.testing.assert_array_equal(n(lists), np.asarray(jl))
    assert counts.dtype == torch.int32 and lists.dtype == torch.int32


def test_reference_tie_and_empty_tile_rules():
    """Ties go to the lowest target index; a tile with no active chunk
    reports (3e12, 0), the TPU kernel's initial carry."""
    tg = np.zeros((1024, 3), np.float32)
    tg[:, 0] = np.arange(1024) % 4  # every target value appears 256 times
    q = np.array([[2.0, 0, 0], [1e6, 1e6, 1e6]], np.float32)
    idx, d = nn_cuda.nn1_sparse(t(q), t(tg), radius=1.0, q_tile=128, t_chunk=128)
    assert int(idx[0]) == 2 and float(d[0]) == 0.0
    qp = pad_rows(t(q), 128, 1.0e6)
    prep = nn_cuda.prepare_sparse_target(t(tg), 128)
    counts = torch.zeros(1, dtype=torch.int32)
    lists = torch.full((1, 8), 8, dtype=torch.int32)
    i2, d2 = nn_cuda.nn1_sparse_reference(qp, prep.tt, counts, lists, 128, 128)
    assert torch.all(i2 == 0) and torch.all(d2 == 3.0e12)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    """CPU tensors never reach the CUDA launch; the launch path refuses
    tensors that are not on CUDA rather than computing anything."""
    def no_launch(*a, **k):
        raise AssertionError("CUDA launch reached with CPU tensors")

    monkeypatch.setattr(nn_cuda, "_launch", no_launch)
    q, tg = _clouds(300, 600, seed=9)
    nn_cuda.nn1_sparse(t(q), t(tg), 4.0, 128, 128)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        nn_cuda._launch(t(q), t(tg).T.contiguous(), torch.zeros(3, dtype=torch.int32),
                        torch.zeros((3, 5), dtype=torch.int32), 128, 128)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card:
    identical index and distance on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    q, tg = _clouds(5000, 20000, seed=11, sentinel_every=13)
    dev = torch.device("cuda")
    prep = nn_cuda.prepare_sparse_target(t(tg).to(dev))
    qp = pad_rows(t(q).to(dev), 1024, 1.0e6).contiguous()
    counts, lists = nn_cuda.tile_chunk_lists(qp, prep, 4.0, 1024)
    ik, dk = nn_cuda.nn1_sparse_chunks(qp, prep.tt, counts, lists, 1024, 512)
    ir, dr = nn_cuda.nn1_sparse_reference(qp, prep.tt, counts, lists, 1024, 512)
    torch.cuda.synchronize()
    assert torch.equal(ik, ir) and torch.equal(dk, dr)

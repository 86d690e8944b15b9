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
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

"""The dense 1-NN (``nn_cuda.nn1_dense``) against the JAX Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version
(``nn1_dense_reference``); the JAX side runs ``nn1_pallas`` in Pallas
interpret mode. Bars: index equal on every row; squared distance within
atol 1e-4 plus rtol 1e-6 (a few f32 ulps: the interpreter's arithmetic
is not the kernel's operation order, and sentinel rows sit near 1e12).
The CUDA kernel itself is held bit for bit against the plain version on
the card (``gpu`` marker here, phase 3 of chip_smoke.py).
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


def _clouds(Q, T, seed, sentinel_every=0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    tg = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    if sentinel_every:
        q[::sentinel_every] = 1.0e6
        tg[:: sentinel_every + 1] = 1.0e6
    return q, tg


def _sorted_clouds():
    rng = np.random.default_rng(5)
    tg = rng.uniform(-30, 30, (2048, 3)).astype(np.float32)
    tg = tg[np.argsort((tg[:, 0] // 2.0) * 1000 + tg[:, 1] // 2.0)]
    q = (tg[::3] + rng.normal(0, 0.2, (len(tg[::3]), 3))).astype(np.float32)
    return q, tg


def _ties():
    """Integer grid targets repeated 4 times: every query has exact ties,
    which go to the lowest target index."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(8), np.arange(4), indexing="ij"), -1)
    tg = np.tile(g.reshape(-1, 3).astype(np.float32), (4, 1))
    q = (g.reshape(-1, 3)[::3] + 0.5).astype(np.float32)
    return q, tg


CASES = {
    # name: (query, target, q_tile, t_chunk)
    "random": (*_clouds(700, 900, seed=2), 128, 128),
    "morton_sorted": (*_sorted_clouds(), 256, 256),
    "sentinels_nonmultiple": (*_clouds(301, 517, seed=3, sentinel_every=11), 128, 256),
    "ties": (*_ties(), 128, 128),
    "default_tiles": (*_clouds(1500, 2100, seed=4, sentinel_every=7), 1024, 512),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn1_dense_matches_pallas(case):
    q, tg, q_tile, t_chunk = CASES[case]
    ij, dj = (np.asarray(x) for x in nn_pallas.nn1_pallas(
        jnp.asarray(q), jnp.asarray(tg), q_tile=q_tile, t_chunk=t_chunk
    ))
    it, dt = (n(x) for x in nn_cuda.nn1_dense(t(q), t(tg), q_tile, t_chunk))
    assert it.dtype == np.int32 and dt.dtype == np.float32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(dt, dj, atol=1e-4, rtol=1e-6)


def test_ties_go_to_the_lowest_index():
    q, tg, q_tile, t_chunk = CASES["ties"]
    idx, d = nn_cuda.nn1_dense(t(q), t(tg), q_tile, t_chunk)
    assert int(idx.max()) < len(tg) // 4  # the first copy always wins
    assert torch.all(d == 0.75)


def test_nn1_best_takes_the_dense_kernel_on_the_accelerator(monkeypatch):
    """knn.nn1_best's accelerator branch is the dense kernel's entry point."""
    from dynamic_direct_lidar_odometry_tpu_torch.core import device

    q, tg = _clouds(300, 400, seed=8)
    monkeypatch.setattr(device, "on_accelerator", lambda x: True)
    calls = []
    real = nn_cuda.nn1_dense_chunks
    monkeypatch.setattr(nn_cuda, "nn1_dense_chunks", lambda *a: calls.append(1) or real(*a))
    idx, _ = knn.nn1_best(t(q), t(tg))
    assert calls == [1]
    np.testing.assert_array_equal(n(idx), n(knn.nn1(t(q), t(tg))[0]))


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    def no_build():
        raise AssertionError("kernel build reached with CPU tensors")

    monkeypatch.setattr(nn_cuda, "build", no_build)
    q, tg = _clouds(300, 600, seed=9)
    nn_cuda.nn1_dense(t(q), t(tg))
    assert nn_cuda.LAUNCHES["nn1_dense"] == 0
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        nn_cuda._check_inputs(t(q), t(tg).T.contiguous())


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card:
    identical index and distance on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    q, tg = _clouds(5000, 20000, seed=11, sentinel_every=13)
    dev = torch.device("cuda")
    qp = pad_rows(t(q).to(dev), 1024, 0.0).contiguous()
    tt = pad_rows(t(tg).to(dev), 512, 1.0e6).T.contiguous()
    ik, dk = nn_cuda.nn1_dense_chunks(qp, tt, 512)
    ir, dr = nn_cuda.nn1_dense_reference(qp, tt)
    torch.cuda.synchronize()
    assert torch.equal(ik, ir) and torch.equal(dk, dr)

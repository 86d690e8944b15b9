"""The JV assignment's kernel module (``ops/hungarian.py``, kernel
``csrc/jv_solve.cu``) against the JAX package's jitted solve.

On the CPU the wrapper runs the kernel's plain version, ``solve_plain``,
which these tests hold to ``hungarian.solve`` / ``assign`` of the JAX
package: identical ``col_of_row`` on every row, including the JAX
scatter's answer for unassigned columns, on integer costs (ties), rows
of the padding constant BIG, NaN costs (never better than a column's
minimum, as in JAX), ``row_valid`` patterns and N = 32, 64 and 128 (the
CLI's and kantplatz trackers, the bench tracker, and twice that). The
wrapper takes the plain version only for CPU tensors, and raises for
any other device that is not CUDA; on the card (``gpu`` marker) the
kernel is held to the plain version, as ``chip_smoke.py`` phase 3 does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu.ops import hungarian as jhungarian
from dynamic_direct_lidar_odometry_tpu_torch.ops import _cuda_build, hungarian


def _cost(kind: str, N: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0, 10, (N, N)).astype(np.float32)
    if kind == "integer_ties":
        return rng.integers(0, 4, (N, N)).astype(np.float32)
    if kind == "big_rows":
        c = rng.uniform(0, 5, (N, N)).astype(np.float32)
        c[rng.random(N) < 0.3] = hungarian.BIG
        c[:, rng.random(N) < 0.2] = hungarian.BIG
        return c
    if kind == "nan":
        c = rng.integers(0, 20, (N, N)).astype(np.float32)
        c[rng.random((N, N)) < 0.1] = np.nan
        return c
    if kind == "all_big":
        return np.full((N, N), hungarian.BIG, np.float32)
    raise ValueError(kind)


def _row_valid(pattern: str, N: int, seed: int):
    rng = np.random.default_rng(seed + 100)
    if pattern == "none":
        return None
    if pattern == "all":
        return np.ones(N, bool)
    if pattern == "first_quarter":  # a tracker's few detections in a large capacity
        return np.arange(N) < N // 4
    if pattern == "random_half":
        return rng.random(N) < 0.5
    if pattern == "empty":
        return np.zeros(N, bool)
    raise ValueError(pattern)


CASES = [
    (kind, N, pattern)
    for N in (32, 64, 128)
    for kind, pattern in [
        ("uniform", "none"), ("integer_ties", "all"), ("integer_ties", "random_half"),
        ("big_rows", "first_quarter"), ("nan", "random_half"),
    ]
] + [("all_big", 64, "all"), ("uniform", 64, "empty"), ("nan", 32, "none")]


@pytest.mark.parametrize("kind, N, pattern", CASES)
def test_solve_plain_matches_jax(kind, N, pattern):
    cost = _cost(kind, N, seed=N)
    rv = _row_valid(pattern, N, seed=N)
    want = np.asarray(jhungarian.solve(jnp.asarray(cost), None if rv is None else jnp.asarray(rv)))
    got = hungarian.solve_plain(torch.from_numpy(cost), None if rv is None else torch.from_numpy(rv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("R, C, seed", [(5, 64, 0), (64, 64, 1), (64, 17, 2), (31, 32, 3)])
def test_assign_matches_jax(R, C, seed):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 6, (R, C)).astype(np.float32)
    cost[rng.random((R, C)) < 0.05] = 5.0e6  # past BIG: clamped to BIG - 1
    rv, cv = rng.random(R) < 0.8, rng.random(C) < 0.7
    want = np.asarray(jhungarian.assign(jnp.asarray(cost), jnp.asarray(rv), jnp.asarray(cv)))
    got = hungarian.assign(torch.from_numpy(cost), torch.from_numpy(rv), torch.from_numpy(cv))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version_without_building(monkeypatch):
    """No CUDA build is reached from CPU tensors; the plain version's host
    reads are counted."""
    def no_build(*a, **k):
        raise AssertionError("a CUDA build was reached from CPU tensors")

    monkeypatch.setattr(_cuda_build, "load", no_build)
    monkeypatch.setattr(_cuda_build, "load_all", no_build)
    cost = torch.from_numpy(_cost("integer_ties", 16, 4))
    hungarian.HOST_READS.clear()
    col = hungarian.solve(cost, torch.ones(16, dtype=torch.bool))
    assert sorted(col.tolist()) == list(range(16))
    assert hungarian.HOST_READS["rows"] == 1 and hungarian.HOST_READS["augment"] == 16
    assert hungarian.HOST_READS["path"] >= 16
    hungarian.assign(cost[:5], torch.ones(5, dtype=torch.bool), torch.ones(16, dtype=torch.bool))


def test_other_devices_raise():
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    fallback."""
    cost = torch.empty((8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        hungarian.solve(cost)
    with pytest.raises(ValueError, match="no kernel"):
        hungarian.solve(cost, torch.ones(8, dtype=torch.bool, device="meta"))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [32, 64, 128])
def test_cuda_kernel_matches_plain_version(N):
    """The kernel against its plain version on the card, one launch per
    solve and no host read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the H100")
    from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

    for kind, pattern in [("uniform", "none"), ("integer_ties", "random_half"), ("big_rows", "all"),
                          ("nan", "first_quarter"), ("all_big", "all")]:
        cost = torch.from_numpy(_cost(kind, N, seed=N + 7)).cuda()
        rv = _row_valid(pattern, N, seed=N + 7)
        rv = None if rv is None else torch.from_numpy(rv).cuda()
        nn_cuda.LAUNCHES.clear()
        hungarian.HOST_READS.clear()
        got = hungarian.solve(cost, rv)
        assert nn_cuda.LAUNCHES["jv_solve"] == 1 and not hungarian.HOST_READS
        torch.testing.assert_close(got.cpu(), hungarian.solve_plain(cost, rv).cpu(), rtol=0, atol=0)

"""The port's multi-process path (``parallel/distributed.py``) against the
JAX package: tests/multihost_worker.py's run, mirrored by two gloo ranks
of tests/torch_dist_worker.py (each computes the covariances of its own
half of the batch and aligns it; no process holds the whole batch), held
to tests/test_multihost.py's single-process JAX reference with that
test's bars. Plus ``initialize``'s and ``global_mesh``'s checks."""

import numpy as np
import pytest
import torch

from test_multihost import _single_process_reference
from torch_parity import spawn_ranks

from dynamic_direct_lidar_odometry_tpu_torch.parallel import distributed, sharding


def test_two_process_dp_matches_the_single_process_jax_run(tmp_path):
    (got, _) = spawn_ranks("dp", 2, tmp_path / "dp")
    T_ref, conv_ref, dT = _single_process_reference()
    np.testing.assert_allclose(got["T"][:, :3, 3], dT[:, 0, :], atol=5e-3)
    np.testing.assert_allclose(got["T"], T_ref, atol=1e-4)
    assert got["converged"].all() and conv_ref.all()


def test_initialize_refuses_to_run_alone(monkeypatch):
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize()
    assert not torch.distributed.is_initialized()


def test_mesh_checks_match_jax(monkeypatch):
    # JAX's make_mesh / global_mesh checks, on one process
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh(3, pt=2, devices=["cpu"])
    with pytest.raises(RuntimeError, match="torch.distributed"):
        sharding.make_mesh(2, pt=2, devices=["cpu"])
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="local process count"):
        distributed.global_mesh(pt=4, device="cpu")
    assert distributed.process_batch_slice(8) == slice(0, 8)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.process_batch_slice(7, sharding.make_mesh(1, devices=["cpu"])._replace(
            shape={"dp": 2, "pt": 1}))

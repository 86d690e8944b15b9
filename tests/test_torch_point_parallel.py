"""Point-parallel (``pt``) registration and odometry in the port
(``torch.distributed``, gloo ranks on the CPU) against the JAX package's
``shard_map`` over a ``pt`` mesh axis on the 8-device virtual CPU mesh.

- A world-size-1 group in this process: ``odometry.step(axis_name=...,
  pt_size=1)`` gives the plain step's bits (the k-NN covariances against
  the full scan are the exact path's, the sums over one rank the
  partials themselves).
- Two ranks: ``batched_align(point_sharded=True)`` on
  tests/test_parallel.py's ``_registration_batch()`` against JAX's
  ``batched_align(make_mesh(2, pt=2), point_sharded=True)`` (that test's
  bars: T within 1e-5, inliers equal), and
  ``point_parallel_pipeline_step`` on ``_tiny_cfg()`` and the town scene
  against JAX's at pt = 2 (poses and residuals within 1e-4).
- Four ranks: the same pipeline step against JAX's at pt = 4.
- Every rank ends with the same bits: the sums are gathered and added in
  rank order on each. Ranks whose states differ raise
  (``distributed.check_agree``).
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from test_parallel import _registration_batch, _tiny_cfg
from torch_parity import n, port_cfg, spawn_ranks

from dynamic_direct_lidar_odometry_tpu.io import synthetic
from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
from dynamic_direct_lidar_odometry_tpu.parallel import sharding as jsharding
from dynamic_direct_lidar_odometry_tpu_torch.odometry import odometry
from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding


def _ranks_equal(outs):
    for k in outs[0].files:
        for o in outs[1:]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


@pytest.fixture
def world_of_one():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_pt1_group_step_is_the_plain_step(world_of_one):
    cfg = port_cfg(dataclasses.replace(_tiny_cfg(), dynamic_detection=False))
    world = synthetic.World.town(seed=0, n_static=4)
    scans = [tuple(torch.from_numpy(np.asarray(a)) for a in synthetic.render_scan(world, T, H=8, W=64))
             for T in synthetic.circular_trajectory(2, radius=6.0, angle_span=0.05)]
    st = odometry.init_state(cfg, *scans[0], device="cpu")
    plain_st, plain = odometry.step(cfg, st, *scans[1])
    pt_st, pt = odometry.step(cfg, st, *scans[1], axis_name=world_of_one, pt_size=1)
    for a, b in ((plain, pt), (plain_st, pt_st)):
        for f in a._fields:
            x, y = getattr(a, f), getattr(b, f)
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(n(y), n(x), err_msg=f)


def test_point_sharded_align_matches_jax_pt2(tmp_path):
    src, m, covs, tgt, tm, tcovs, guess, shift = _registration_batch()
    settings = jgicp.GICPSettings(max_iterations=16)
    ref = jsharding.batched_align(jsharding.make_mesh(2, pt=2), settings, point_sharded=True)(
        src, m, covs, tgt, tm, tcovs, guess)
    inputs = tmp_path / "in.npz"
    np.savez(inputs, src=src, m=m, covs=covs, tgt=tgt, tm=tm, tcovs=tcovs, guess=guess)
    outs = spawn_ranks("align_pt", 2, tmp_path / "al", inputs)
    _ranks_equal(outs)
    got = outs[0]
    np.testing.assert_allclose(got["res.T"], np.asarray(ref.T), atol=1e-5)
    np.testing.assert_array_equal(got["res.num_inliers"], np.asarray(ref.num_inliers))
    np.testing.assert_allclose(got["res.T"][:, :3, 3], shift[:, 0, :], atol=2e-2)
    np.testing.assert_allclose(got["res.residuals"], np.asarray(ref.residuals), atol=1e-4)


def _jax_pt_pipeline(pt):
    cfg = _tiny_cfg()
    world = synthetic.World.town(seed=0, n_static=4)
    pts, mask = synthetic.render_scan(world, np.eye(4), H=cfg.detection.rows, W=cfg.detection.columns)
    pts_b, mask_b = jnp.asarray(pts)[None], jnp.asarray(mask)[None]
    states = jsharding.batched_init_state(cfg, pts_b, mask_b, jnp.zeros((1,), jnp.float32))
    mesh = jsharding.make_mesh(pt, pt=pt)
    _, outputs = jsharding.point_parallel_pipeline_step(cfg, mesh)(
        states, pts_b, mask_b, jnp.full((1,), 0.1, jnp.float32))
    return pts, mask, outputs


@pytest.mark.parametrize("pt", [2, 4])
def test_point_parallel_pipeline_matches_jax(tmp_path, pt):
    pts, mask, ref = _jax_pt_pipeline(pt)
    inputs = tmp_path / "in.npz"
    np.savez(inputs, pts=pts, mask=mask)
    outs = spawn_ranks("pipe_pt", pt, tmp_path / "pp", inputs)
    _ranks_equal(outs)
    got = outs[0]
    np.testing.assert_allclose(got["out.odom.pose"], np.asarray(ref.odom.pose), atol=1e-4)
    np.testing.assert_allclose(got["out.odom.residuals"], np.asarray(ref.odom.residuals), atol=1e-4)
    assert got["out.odom.residuals"].shape == (1, _tiny_cfg().capacity.max_points)
    np.testing.assert_array_equal(got["out.keyframe_added"], np.asarray(ref.keyframe_added))


def test_ranks_whose_states_differ_raise(tmp_path):
    """``distributed.check_agree``, which ``point_parallel_pipeline_step``
    runs after every stream's step: a state every rank holds passes, one
    leaf that differs on one rank raises on every rank."""
    outs = spawn_ranks("agree", 2, tmp_path / "ag")
    assert [bool(o["raised"]) for o in outs] == [True, True]


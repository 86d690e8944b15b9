"""Batched streams on one card (``parallel/sharding.py``,
``parallel/replay.py``) against the JAX package's vmapped ones.

- ``batched_align`` against ``jax.vmap(gicp.align)`` on
  tests/test_parallel.py's registration batch and on a batch whose
  streams stop at different iterations (one degenerate, one on the LM
  iteration cap): T within 1e-5, iterations, inliers, convergence and
  correspondences equal; each stream as the port's single-stream
  ``align`` gives it.
- The batched sparse 1-NN entry's plain version: bit-equal to B single
  calls, ties and far queries included.
- ``replay_batch`` against JAX's ``replay_batch`` (4 streams x 3 scans at
  tests/test_parallel.py's tiny shapes): 5e-5 m (measured 1.05e-5 with
  GICP's host sums in XLA's order, ops/gicp_xla.py; 1.87e-4 before, when
  the bar was test_parallel.py's 2e-4; tools/torch_jax_gaps.py); the
  batched final state against JAX's through ``interop``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_parallel import _registration_batch
from torch_parity import n, port_cfg

from dynamic_direct_lidar_odometry_tpu import config as cfg_lib
from dynamic_direct_lidar_odometry_tpu.io import dataset
from dynamic_direct_lidar_odometry_tpu.ops import covariance
from dynamic_direct_lidar_odometry_tpu.ops import gicp as jgicp
from dynamic_direct_lidar_odometry_tpu.parallel import replay as jreplay
from dynamic_direct_lidar_odometry_tpu_torch import interop
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp, nn_cuda
from dynamic_direct_lidar_odometry_tpu_torch.parallel import replay, sharding

CPU = sharding.make_mesh(1, devices=["cpu"])


def _varied_batch(B=6, N=256, seed=3):
    """Streams turned by 0.04 b rad and shifted up to 0.1 b m, one with
    a third of its source masked, the last 100 m off (no correspondence
    inside the gate: the degenerate-H stop)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-5, 5, (B, N, 3)).astype(np.float32)
    tgt = np.empty_like(src)
    for b in range(B):
        th = 0.04 * b
        R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]])
        tgt[b] = src[b] @ R.T + rng.uniform(-0.1 * b, 0.1 * b, 3)
    tgt[B - 1] += 100.0
    tgt = tgt.astype(np.float32)
    m = np.ones((B, N), bool)
    m[1, ::3] = False
    cv = jax.vmap(lambda p: covariance.plane_covariances(p, jnp.ones((N,), bool), k=8))
    return (jnp.asarray(src), jnp.asarray(m), cv(jnp.asarray(src)), jnp.asarray(tgt),
            jnp.ones((B, N), bool), cv(jnp.asarray(tgt)), jnp.broadcast_to(jnp.eye(4), (B, 4, 4)))


CASES = {
    "registration-batch": (lambda: _registration_batch(seed=1)[:7], dict(max_iterations=8)),
    "varied": (_varied_batch, dict(max_iterations=16)),
    "varied-lm-cap": (_varied_batch, dict(max_iterations=16, lm_max_iterations=2,
                                          lm_init_lambda_factor=1e3)),
    "varied-gn-trace": (_varied_batch, dict(max_iterations=6, optimizer="gn", record_trace=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batched_align_matches_jax_vmap(case):
    make, kw = CASES[case]
    args = make()
    ref = jax.vmap(lambda *a: jgicp.align(*a, jgicp.GICPSettings(**kw)))(*args)
    s = gicp.GICPSettings(**kw)
    res = sharding.batched_align(CPU, s)(*(np.array(a) for a in args))
    np.testing.assert_allclose(n(res.T), np.asarray(ref.T), atol=1e-5)
    for f in ("iterations", "num_inliers", "converged", "correspondences"):
        np.testing.assert_array_equal(n(getattr(res, f)), np.asarray(getattr(ref, f)), err_msg=f)
    np.testing.assert_allclose(n(res.residuals), np.asarray(ref.residuals), atol=1e-4)
    assert n(res.pose_trace).shape == np.asarray(ref.pose_trace).shape
    if s.record_trace:
        np.testing.assert_allclose(n(res.pose_trace), np.asarray(ref.pose_trace), atol=1e-5)
    for b in range(len(args[0])):
        one = gicp.align(*(torch.from_numpy(np.array(a[b])) for a in args), s)
        np.testing.assert_allclose(n(one.T), n(res.T[b]), atol=1e-5)
        assert int(one.iterations) == int(res.iterations[b])
        assert int(one.num_inliers) == int(res.num_inliers[b])


def test_batched_sparse_entry_plain_version_equals_single_calls():
    rng = np.random.default_rng(0)
    B, Q, M = 3, 2500, 3000
    tgt = torch.from_numpy(rng.uniform(-10, 10, (B, M, 3)).astype(np.float32))
    tgt[1, 100:] = 1e6  # a mostly invalid target
    tgt[2, 20] = tgt[2, 10]  # a tie: the lower index wins
    q = torch.from_numpy(rng.uniform(-10, 10, (B, Q, 3)).astype(np.float32))
    q[0, :5] = tgt[0, 7:12]
    q[2, 50] = 1e6  # a sentinel query (it may meet the target padding)
    q[2, 60] = tgt[2, 10]
    q[1, 1024:2048] = 1e6  # an empty tile
    prep = nn_cuda.prepare_sparse_targets(tgt)
    bi, bd = nn_cuda.nn1_sparse_batched_prepared(q, prep, 1.0)
    assert int(bi[2, 60]) == 10 and float(bd[1, 1500]) >= 3e12
    for b in range(B):
        i, d = nn_cuda.nn1_sparse_prepared(q[b], nn_cuda.prepare_sparse_target(tgt[b]), 1.0)
        np.testing.assert_array_equal(n(bi[b]), n(i))
        np.testing.assert_array_equal(n(bd[b]), n(d))


def _tiny_cfg():
    cfg = cfg_lib.doals_config()
    return dataclasses.replace(
        cfg,
        detection=dataclasses.replace(cfg.detection, rows=16, columns=128, ground_rows=4),
        capacity=cfg_lib.CapacityConfig(
            max_points=512, max_submap_points=2048, max_keyframes=8,
            max_keyframe_points=512, max_objects=4, max_tracks=4, nn_chunk=128,
        ),
    )


def test_replay_batch_matches_jax():
    cfg = _tiny_cfg()
    B, S = 4, 3
    seqs = [dataset.synthetic_sequence(n_scans=S, H=16, W=128, n_dynamic=0, seed=i) for i in range(B)]
    points = np.stack([s.points for s in seqs])
    masks = np.stack([s.mask for s in seqs])
    stamps = np.stack([s.stamps for s in seqs])
    want = jreplay.replay_batch(cfg, points, masks, stamps)
    got = replay.replay_batch(port_cfg(cfg), points, masks, stamps, mesh=CPU)
    assert got.poses.shape == want.poses.shape == (B, S - 1, 3)
    np.testing.assert_allclose(got.poses, want.poses, atol=5e-5)
    np.testing.assert_allclose(got.quats, want.quats, atol=5e-5)
    np.testing.assert_array_equal(got.num_keyframes, want.num_keyframes)

    # the vmapped JAX state and the port's stacked one cross over leaf by
    # leaf (interop keeps the leading B)
    j_final = jax.tree_util.tree_map(np.asarray, want.final_states)
    bridged = interop.state_from_numpy(j_final, "cpu")
    assert bridged.odom.T.shape == got.final_states.odom.T.shape == (B, 4, 4)
    np.testing.assert_allclose(n(got.final_states.odom.T), n(bridged.odom.T), atol=5e-5)
    np.testing.assert_array_equal(interop.state_to_numpy(bridged).odom.store.count,
                                  j_final.odom.store.count)
    np.testing.assert_array_equal(n(got.final_states.odom.store.count), j_final.odom.store.count)


def test_batched_init_state_matches_jax():
    from dynamic_direct_lidar_odometry_tpu.parallel import sharding as jsharding

    cfg = _tiny_cfg()
    seq = dataset.synthetic_sequence(n_scans=2, H=16, W=128, n_dynamic=0, seed=5)
    pts, msk = np.stack([seq.points[0], seq.points[1]]), np.stack([seq.mask[0], seq.mask[1]])
    ts = np.zeros((2,), np.float32)
    want = jax.tree_util.tree_map(np.asarray, jsharding.batched_init_state(
        cfg, jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(ts)))
    got = interop.state_to_numpy(sharding.batched_init_state(port_cfg(cfg), pts, msk, ts, device="cpu"))
    np.testing.assert_array_equal(got.odom.prev_points, want.odom.prev_points)
    np.testing.assert_array_equal(got.odom.prev_mask, want.odom.prev_mask)
    np.testing.assert_array_equal(got.odom.store.count, want.odom.store.count)


def test_mesh_is_one_device():
    """Without a process group the mesh is this process's one device:
    JAX's divisibility check holds, more devices need torch.distributed
    ranks (tests/test_torch_point_parallel.py), and point-sharding over a
    pt axis of one is the unsharded aligner, bit for bit."""
    assert CPU.device == torch.device("cpu") and CPU.shape == {"dp": 1, "pt": 1}
    with pytest.raises(ValueError, match="not divisible"):
        sharding.make_mesh(1, pt=2, devices=["cpu"])
    with pytest.raises(RuntimeError, match="torch.distributed"):
        sharding.make_mesh(2, devices=["cpu"])
    args = [np.array(a) for a in _varied_batch(B=2, N=128)]
    s = gicp.GICPSettings(max_iterations=8)
    one = sharding.batched_align(CPU, s, point_sharded=True)(*args)
    ref = sharding.batched_align(CPU, s)(*args)
    for f in ("T", "iterations", "num_inliers", "residuals", "correspondences"):
        np.testing.assert_array_equal(n(getattr(one, f)), n(getattr(ref, f)), err_msg=f)

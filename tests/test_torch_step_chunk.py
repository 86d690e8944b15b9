"""``pipeline.step_chunk``: K sequential steps with the hull masks held
for the chunk and every output field stacked over a new leading axis, on
tests/test_pipeline.py's scene (K = 3), its submap cut to 8,192 points
so the exact CPU sweeps stay quick.

- Against K sequential port steps: that test's bar (1e-5 m), the same
  keyframe flags and store count.
- Against the JAX package's ``step_chunk`` (its ``lax.scan``): the poses
  within 1e-6 (measured 0 on an 8-core Xeon, tools/torch_jax_gaps.py),
  the same keyframe flags and store count. (The bar was the single-step
  parity bar, 1e-3 m and 1e-3 rad, while the port was 5.5e-4 m from JAX
  at this scene's scan 2 in z; GICP's host sums in XLA's order,
  tests/test_torch_gicp_bits.py, closed that.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from test_pipeline import ddlo_cfg
from torch_parity import n, port_cfg

from dynamic_direct_lidar_odometry_tpu import pipeline as jpipe
from dynamic_direct_lidar_odometry_tpu.io import synthetic
from dynamic_direct_lidar_odometry_tpu_torch import pipeline


def _scans(cfg):
    H, W = cfg.detection.rows, cfg.detection.columns
    world = synthetic.World.town(seed=4, n_static=8)
    rng = np.random.default_rng(0)
    scans = []
    for i in range(4):
        T = np.eye(4)
        T[:3, 3] = [0.15 * i, 0.02 * i, 0.0]
        scans.append(synthetic.render_scan(world, T, H=H, W=W, t=0.1 * i, rng=rng))
    return scans


def test_step_chunk_matches_sequential_steps_and_jax():
    cfg = ddlo_cfg()
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_submap_points=8192))
    pcfg = port_cfg(cfg)
    scans = _scans(cfg)
    pts = np.stack([s[0] for s in scans[1:]])
    msk = np.stack([s[1] for s in scans[1:]])
    ts = np.arange(1, 4, dtype=np.float32) * 0.1

    st0 = pipeline.init_state(pcfg, *scans[0], 0.0, device="cpu")
    st_seq, poses_seq, added = st0, [], []
    for i in range(3):
        st_seq, out = pipeline.step(pcfg, st_seq, pts[i], msk[i], torch.tensor(ts[i]))
        poses_seq.append(n(out.odom.pose))
        added.append(bool(out.keyframe_added))
    st_chunk, outs = pipeline.step_chunk(pcfg, st0, pts, msk, ts)
    assert outs.odom.pose.shape == (3, 3) and outs.detections.labels.shape[0] == 3
    np.testing.assert_allclose(n(outs.odom.pose), np.stack(poses_seq), atol=1e-5)
    np.testing.assert_allclose(n(st_chunk.odom.T), n(st_seq.odom.T), atol=1e-5)
    assert n(outs.keyframe_added).tolist() == added
    assert int(st_chunk.odom.store.count) == int(st_seq.odom.store.count)

    j0 = jpipe.init_state(cfg, jnp.asarray(scans[0][0]), jnp.asarray(scans[0][1]), 0.0)
    j_chunk, j_outs = jpipe.step_chunk(cfg, j0, jnp.asarray(pts), jnp.asarray(msk), jnp.asarray(ts))
    np.testing.assert_allclose(n(outs.odom.T), np.asarray(j_outs.odom.T), rtol=0, atol=1e-6)
    assert n(outs.keyframe_added).tolist() == np.asarray(j_outs.keyframe_added).tolist()
    assert int(st_chunk.odom.store.count) == int(j_chunk.odom.store.count)

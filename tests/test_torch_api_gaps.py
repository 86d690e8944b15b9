"""The small API of the JAX package that the pipeline does not call,
ported for its users and oracles: ``core/cloud.py``'s ``from_array``,
``empty``, ``Cloud.count`` and ``Cloud.sanitized``; ``core/se3.py``'s
``identity``; ``ops/segmentation.py``'s exact per-root gates
``segment_stats`` and ``compact_segments`` (the oracles of
``segment_objects``, tests/test_detection_ops.py:176-260); and
``parallel/sharding.py``'s ``shard_batch`` called by its JAX keywords.
Each against its JAX function on the same inputs."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_detection_ops import _stats_kwargs, _two_blob_image
from torch_parity import n

from dynamic_direct_lidar_odometry_tpu.core import cloud as jcloud
from dynamic_direct_lidar_odometry_tpu.core import se3 as jse3
from dynamic_direct_lidar_odometry_tpu.ops import segmentation as jseg
from dynamic_direct_lidar_odometry_tpu.parallel import sharding as jsharding
from dynamic_direct_lidar_odometry_tpu_torch.core import cloud, se3
from dynamic_direct_lidar_odometry_tpu_torch.ops import segmentation
from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding


@pytest.mark.parametrize("capacity", [None, 40])
@pytest.mark.parametrize("masked", [False, True])
def test_cloud_helpers_match_jax(capacity, masked):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(32, 3)).astype(np.float32)
    pts[[3, 9]] = np.nan
    mask = rng.uniform(size=32) < 0.7 if masked else None
    want = jcloud.from_array(jnp.asarray(pts), capacity, None if mask is None else jnp.asarray(mask))
    got = cloud.from_array(pts, capacity, mask, device="cpu")
    np.testing.assert_array_equal(n(got.points), np.asarray(want.points))
    np.testing.assert_array_equal(n(got.mask), np.asarray(want.mask))
    assert int(got.count()) == int(want.count())
    np.testing.assert_array_equal(n(got.sanitized().points), np.asarray(want.sanitized().points))
    assert got.capacity == want.capacity
    with pytest.raises(ValueError, match="exceeds capacity"):
        cloud.from_array(pts, 16, device="cpu")


def test_empty_cloud_and_identity_match_jax():
    e, je = cloud.empty(8, device="cpu"), jcloud.empty(8)
    np.testing.assert_array_equal(n(e.points), np.asarray(je.points))
    np.testing.assert_array_equal(n(e.mask), np.asarray(je.mask))
    assert e.points.dtype == torch.float32 and int(e.count()) == 0
    np.testing.assert_array_equal(n(se3.identity(device="cpu")), np.asarray(jse3.identity()))


def _blobby(seed, H=24, W=96):
    """tests/test_detection_ops.py's random blobby range image."""
    rng = np.random.default_rng(seed)
    ranges = np.full((H, W), 20.0, np.float32)
    for _ in range(8):
        r0, c0 = rng.integers(0, H - 6), rng.integers(0, W - 10)
        h, w = rng.integers(3, 7), rng.integers(4, 11)
        ranges[r0 : r0 + h, c0 : c0 + w] = rng.uniform(3.0, 8.0)
    eligible = np.ones((H, W), bool)
    eligible[rng.uniform(size=(H, W)) < 0.05] = False
    res_img = ((rng.uniform(size=(H, W)) < 0.3) * rng.uniform(0.0, 0.5, (H, W))).astype(np.float32)
    return ranges, eligible, res_img


@pytest.mark.parametrize("scene", ["two-blobs", 0, 1, 2])
def test_segment_stats_and_compact_segments_match_jax(scene):
    if scene == "two-blobs":
        ranges, eligible = _two_blob_image()
        res_img = np.zeros_like(ranges)
    else:
        ranges, eligible, res_img = _blobby(scene)
    H, W = ranges.shape
    theta, ax, ay = 0.25, 360.0 / W, 2 * 45.0 / (H - 1)
    labels = jseg.label_components(jnp.asarray(ranges), jnp.asarray(eligible), theta, ax, ay).labels
    zz = np.linspace(2.0, 0.0, H)[:, None].repeat(W, 1).astype(np.float32)
    pts = np.stack([ranges, np.zeros_like(ranges), zz], axis=-1)
    kw = _stats_kwargs()
    want = jseg.segment_stats(labels, jnp.asarray(ranges), jnp.asarray(pts), jnp.asarray(res_img),
                              jnp.float32(0.0), **kw)
    lab = torch.from_numpy(np.array(labels))
    got = segmentation.segment_stats(lab, torch.from_numpy(ranges), torch.from_numpy(pts),
                                     torch.from_numpy(res_img), torch.tensor(0.0), **kw)
    for f in ("size", "line_count", "min_z", "max_z", "max_dist", "feasible"):
        np.testing.assert_array_equal(n(getattr(got, f)), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(n(got.avg_residuum), np.asarray(want.avg_residuum), rtol=1e-6)
    assert int(n(got.feasible).sum()) >= 2

    for s_want, s_got in zip(jseg.compact_segments(labels, want, max_objects=6),
                             segmentation.compact_segments(lab, got, max_objects=6)):
        np.testing.assert_array_equal(n(s_got), np.asarray(s_want))

    # the oracle's role: the fused candidate path reproduces it
    roots, valid, ps, _ = segmentation.segment_objects(
        lab, torch.from_numpy(ranges), torch.from_numpy(pts), torch.from_numpy(res_img),
        torch.tensor(0.0), **kw, max_objects=6, candidates=64)
    exact = segmentation.compact_segments(lab, got, max_objects=6)
    for a, b in zip((roots, valid, ps), exact):
        np.testing.assert_array_equal(n(a), n(b))


def test_shard_batch_takes_jax_keywords():
    """``shard_batch(mesh, tree=...)``: the parameters' names and order are
    JAX's (read from its signature, not called), and a keyword call places
    a container's leaves on the mesh's device."""
    names = list(inspect.signature(sharding.shard_batch).parameters)
    assert names == list(inspect.signature(jsharding.shard_batch).parameters)
    mesh = sharding.make_mesh(1, devices=["cpu"])
    x = (np.arange(6, dtype=np.float32).reshape(2, 3), None, [np.ones(2, bool)])
    got = sharding.shard_batch(mesh, tree=x, point_sharded_leaves=())
    assert isinstance(got[0], torch.Tensor) and got[1] is None
    np.testing.assert_array_equal(n(got[0]), x[0])
    np.testing.assert_array_equal(n(got[2][0]), x[2][0])

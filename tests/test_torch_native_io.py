"""The port's native scan-IO bindings (``io/native.py``, the repo's
``native/scanio`` built with its own Makefile into a build directory of
the port's) against the JAX package's reader on the same files: every
case of tests/test_native_io.py; ``io.pcd.save_pcd`` (numpy) byte for byte
against the JAX package's, and the native writer's file read back by both
readers."""

import os

import numpy as np
import pytest

from test_native_io import _write_scans

from dynamic_direct_lidar_odometry_tpu.io import native as jnative
from dynamic_direct_lidar_odometry_tpu.io import pcd as jpcd
from dynamic_direct_lidar_odometry_tpu_torch.io import native, pcd


def test_the_port_builds_its_own_library():
    assert native.available()
    assert native._SO_PATH != jnative._SO_PATH
    assert os.path.exists(native._SO_PATH)


def test_native_load_pcd_matches_jax(tmp_path):
    paths, clouds = _write_scans(tmp_path, n=2)
    for path, (pts, mask) in zip(paths, clouds):
        xyz, m = native.load_pcd_native(path, capacity=256)
        jxyz, jm = jnative.load_pcd_native(path, capacity=256)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(xyz, jxyz)
        assert m.sum() == mask.sum() and not m[200:].any()
        np.testing.assert_allclose(xyz[:200][mask], pts[mask], atol=1e-5)


def test_prefetching_reader_matches_jax(tmp_path):
    paths, _ = _write_scans(tmp_path, n=5)
    stamps = [10.0 + 0.1 * i for i in range(5)]
    reader = native.PrefetchingReader(paths, capacity=256, stamps=stamps)
    jreader = jnative.PrefetchingReader(paths, capacity=256, stamps=stamps)
    assert len(reader) == len(jreader) == 5
    got, want = list(reader), list(jreader)
    assert len(got) == 5
    for (xyz, m, ts), (jxyz, jm, jts) in zip(got, want):
        assert ts == jts
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(xyz, jxyz)
    reader.close()
    jreader.close()


@pytest.mark.parametrize("binary,intensity", [(True, False), (False, False), (True, True)])
def test_save_pcd_is_byte_equal_to_jax(tmp_path, binary, intensity):
    rng = np.random.default_rng(3)
    pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = rng.random(500) < 0.7
    inten = rng.random(500).astype(np.float32) if intensity else None
    a, b = str(tmp_path / "port.pcd"), str(tmp_path / "jax.pcd")
    assert pcd.save_pcd(a, pts, mask, inten, binary=binary) == int(mask.sum())
    assert jpcd.save_pcd(b, pts, mask, inten, binary=binary) == int(mask.sum())
    assert open(a, "rb").read() == open(b, "rb").read()


def test_native_writer_roundtrip(tmp_path):
    pts = np.random.default_rng(0).uniform(-10, 10, (500, 3)).astype(np.float32)
    mask = np.random.default_rng(1).random(500) < 0.7
    path = str(tmp_path / "out.pcd")
    assert native.save_pcd_native(path, pts, mask) == int(mask.sum())
    back, _ = jpcd.load_pcd(path)
    np.testing.assert_array_equal(back[:, :3], pts[mask])
    xyz, m = native.load_pcd_native(path, capacity=500)
    np.testing.assert_array_equal(xyz[m], pts[mask])

"""Helpers of the replay / CLI parity tests (tests/test_torch_runner*.py,
tests/test_torch_cli.py): the scenes of tests/test_runner.py, and
comparisons of the files a run writes, numerically and in format."""

from __future__ import annotations

import dataclasses
import json
import os
import re

import numpy as np

from test_runner import _seq, _small_cfg  # noqa: F401 (re-exported)

from torch_parity import port_cfg

from dynamic_direct_lidar_odometry_tpu import runner as jrunner
from dynamic_direct_lidar_odometry_tpu.io import pcd as jpcd
from dynamic_direct_lidar_odometry_tpu_torch import runner

# every artifact of a replay
ARTIFACTS = dict(evaluate=True, save_every=4, export_clouds_every=3, map_capacity=20_000)

_NUM = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _both(cfg, seq, root, **kw):
    """The JAX and the port replay of one scene (the port on the CPU)
    into root/jax and root/port: (jax result, port result, dirs)."""
    jd, pd = os.path.join(root, "jax"), os.path.join(root, "port")
    jr = jrunner.replay(cfg, seq, out_dir=jd, **kw)
    pr = runner.replay(port_cfg(cfg), seq, out_dir=pd, device="cpu", **kw)
    return jr, pr, jd, pd


def lean_cfg(seq):
    """tests/test_runner.py's configuration with capacities cut to what
    its 16 x 128 scenes fill (about 1,250 registration points and 1,100
    per keyframe): the exact CPU NN sweeps, most of a test's time, scale
    with them."""
    cfg = _small_cfg(seq.H, seq.W)
    return dataclasses.replace(cfg, capacity=dataclasses.replace(
        cfg.capacity, max_points=1536, max_keyframe_points=1536, max_submap_points=4608))


def dynamic_cfg(cfg):
    """tests/test_runner.py's track-log configuration: a mover goes
    UNDEFINED -> STATIC -> DYNAMIC by scan 6."""
    return dataclasses.replace(
        cfg,
        tracking=dataclasses.replace(
            cfg.tracking, max_undefined_hits=2, min_dynamic_hits=4,
            min_dist_from_origin=0.7, residuum_height_ratio=0.0,
        ),
    )


def files_under(root):
    """Relative paths of every file under ``root``, the timestamped
    evaluation session directory renamed to ``SESSION``."""
    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            rel = os.path.relpath(os.path.join(d, f), root)
            parts = rel.split(os.sep)
            if re.match(r"^\d{4}_\d{2}_\d{2}-", parts[0]) and len(parts) > 1:
                parts[0] = "SESSION"
            out[os.sep.join(parts)] = os.path.join(d, f)
    return out


def assert_text_close(a: str, b: str, atol: float):
    """Same lines and tokens; numeric tokens within ``atol`` and of the
    same kind (integer, fixed or exponent notation), others equal. The
    writers themselves are held byte for byte in tests/test_torch_cli.py."""
    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    assert len(la) == len(lb), (a, len(la), len(lb))
    for x, y in zip(la, lb):
        tx, ty = x.split(), y.split()
        assert len(tx) == len(ty), (a, x, y)
        for u, v in zip(tx, ty):
            if _NUM.match(u) and _NUM.match(v):
                assert abs(float(u) - float(v)) <= atol, (a, x, y)
                assert ("." in u, "e" in u.lower()) == ("." in v, "e" in v.lower()), (a, x, y)
            else:
                assert u == v, (a, x, y)


def assert_pcd_close(a: str, b: str, atol: float):
    """Same header (so the same point count and fields), points within
    ``atol`` plus 2e-5 of their coordinate (the lever arm of a 1e-5 rad
    rotation difference) in the same order; extra fields (the S2M residual) within
    5 x ``atol``: a residual is a distance to a submap point, and a
    submap voxel centroid can take a point more or less by rounding."""
    ha, hb = open(a, "rb").read(), open(b, "rb").read()
    cut = ha.index(b"DATA")
    assert ha[: ha.index(b"\n", cut)] == hb[: hb.index(b"\n", cut)], (a, b)
    (pa, ea), (pb, eb) = jpcd.load_pcd(a), jpcd.load_pcd(b)
    np.testing.assert_allclose(pa, pb, atol=atol, rtol=2e-5, err_msg=a)
    assert ea.keys() == eb.keys()
    for k in ea:
        np.testing.assert_allclose(ea[k], eb[k], atol=5 * atol, err_msg=f"{a}:{k}")


def assert_tracks_close(a: str, b: str, atol: float):
    """Same records; states within ``atol``, velocities (Kalman state:
    position differences over a 0.1 s scan period) within 5 x ``atol``."""
    ra = [json.loads(x) for x in open(a)]
    rb = [json.loads(x) for x in open(b)]
    assert len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert x.keys() == y.keys()
        for k in ("scan", "stamp", "id", "status", "hits", "matched"):
            assert x[k] == y[k], (k, x, y)
        np.testing.assert_allclose(x["state"], y["state"], atol=atol)
        np.testing.assert_allclose(x["velocity"], y["velocity"], atol=5 * atol)


def assert_run_files_close(jax_dir: str, port_dir: str, atol: float = 2e-4):
    """Every file of a JAX replay's output directory has a counterpart in
    the port's, with the same name, format and numbers."""
    jf, pf = files_under(jax_dir), files_under(port_dir)
    assert sorted(jf) == sorted(pf)
    for rel in jf:
        a, b = jf[rel], pf[rel]
        if rel.endswith(".pcd"):
            assert_pcd_close(a, b, atol)
        elif rel.endswith(".jsonl"):
            assert_tracks_close(a, b, atol)
        elif rel.endswith(".txt") or rel.endswith(".yaml"):
            assert_text_close(a, b, atol)
        elif rel.endswith(".npz"):
            continue  # checkpoints: tests/test_torch_runner_ckpt.py
        else:
            raise AssertionError(f"unexpected file {rel}")


def assert_results_close(jr, pr, atol: float = 5e-4):
    """The ReplayResult fields the parity bars name. Poses and quaternions
    within 5e-4 (the scenes here measure up to 1.1e-4; the per-scan
    pipeline parity bar is 1e-3 m)."""
    assert pr.poses.shape == jr.poses.shape
    np.testing.assert_allclose(pr.poses, jr.poses, atol=atol)
    np.testing.assert_allclose(pr.quats, jr.quats, atol=atol)
    np.testing.assert_array_equal(pr.stamps, jr.stamps)
    assert pr.num_keyframes == jr.num_keyframes
    np.testing.assert_array_equal(pr.dynamic_counts, jr.dynamic_counts)
    assert pr.map_points == jr.map_points
    assert pr.dropped_scans == jr.dropped_scans
    assert pr.keyframe_overflow == jr.keyframe_overflow

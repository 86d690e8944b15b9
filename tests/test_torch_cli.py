"""The port's CLI, demo and host-side writers against the JAX
package's: ``cli.main(["synth" | "run", ...])`` (the configuration
``run`` builds; a whole run is in tests/test_torch_cli_run.py), the TUM / object-trajectory /
evaluation-dump / PCD / PNG writers byte for byte, ``ate_rmse``, the
dashboard text and the profiling statistics."""

import os
import re

import numpy as np
import pytest
import torch

from torch_parity import port_cfg

from dynamic_direct_lidar_odometry_tpu import cli as jcli
from dynamic_direct_lidar_odometry_tpu import runner as jrunner
from dynamic_direct_lidar_odometry_tpu.io import pcd as jpcd
from dynamic_direct_lidar_odometry_tpu.io import pointcloud2 as jpc2
from dynamic_direct_lidar_odometry_tpu.utils import evaldump as jevaldump
from dynamic_direct_lidar_odometry_tpu.utils import profiling as jprofiling
from dynamic_direct_lidar_odometry_tpu.utils import trajectory as jtrajectory
from dynamic_direct_lidar_odometry_tpu.utils import viz as jviz
from dynamic_direct_lidar_odometry_tpu_torch import cli, runner
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset, demo, pcd, pointcloud2
from dynamic_direct_lidar_odometry_tpu_torch.utils import evaldump, profiling, trajectory, viz

SYNTH = ["synth", "--scans", "4", "--rows", "16", "--cols", "128", "--dynamic", "1"]


@pytest.fixture(scope="module")
def seq_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("seq") / "seq.npz")
    assert cli.main(SYNTH + ["--out", path]) == 0
    return path


def test_synth_writes_the_jax_sequence(seq_path, tmp_path):
    jpath = str(tmp_path / "jax.npz")
    assert jcli.main(SYNTH + ["--out", jpath]) == 0
    a, b = np.load(seq_path), np.load(jpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s = dataset.ScanSequence.load(jpath)  # either package reads the other's files
    assert (len(s), s.H, s.W) == (4, 16, 128) and s.gt_poses is not None


class _Stop(Exception):
    pass


@pytest.mark.parametrize("extra", [[], ["--no-dynamic"]])
def test_run_builds_the_jax_cli_config(seq_path, monkeypatch, extra):
    """The configuration and replay arguments ``run`` passes, captured
    from both CLIs: equal field by field; the port adds the device."""
    got = {}

    def capture(key):
        def fake(cfg, seq, **kw):
            got[key] = (cfg, kw)
            raise _Stop

        return fake

    monkeypatch.setattr(jrunner, "replay", capture("jax"))
    monkeypatch.setattr(runner, "replay", capture("port"))
    args = ["run", "--dataset", seq_path, "--out", "x", "--checkpoint-every", "3", "--save-every", "2"]
    for main in (jcli.main, cli.main):
        with pytest.raises(_Stop):
            main(args + extra + (["--device", "cpu"] if main is cli.main else []))
    (jcfg, jkw), (pcfg, pkw) = got["jax"], got["port"]
    assert pcfg == port_cfg(jcfg)
    assert pcfg.capacity.max_keyframes == 128  # capacity_for_scan: the blocked hulls
    assert pkw == dict(jkw, device="cpu")


def test_run_needs_the_card_unless_told(seq_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["run", "--dataset", seq_path, "--quiet"])


def test_convert_fails_like_the_jax_cli(tmp_path):
    args = ["convert", "--bag", "x.bag", "--topic", "/points", "--rows", "4", "--cols", "4",
            "--out", str(tmp_path / "o.npz")]
    with pytest.raises(ImportError) as jerr:
        jcli.main(args)
    with pytest.raises(ImportError) as perr:
        cli.main(args)
    assert str(perr.value) == str(jerr.value)


def test_demo_runs_on_the_cpu(capsys):
    assert demo.main(3, "cpu") == 0
    assert "done: 2 scans" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# writers: byte for byte


def _rng_poses(rng, k):
    T = np.tile(np.eye(4), (k, 1, 1))
    T[:, :3, 3] = rng.uniform(-20, 20, (k, 3))
    return T


def test_trajectory_writers_are_byte_identical(tmp_path):
    outs = []
    for mod, tag in ((trajectory, "p"), (jtrajectory, "j")):
        rec, obj = mod.PoseRecorder(), mod.ObjectTrajectories()
        r = np.random.default_rng(1)
        for i in range(5):
            q = r.normal(size=4)
            rec.append(0.1 * i, r.uniform(-5, 5, 3).astype(np.float32), (q / np.linalg.norm(q)).astype(np.float32))
            obj.update(np.array([3, 7, 9]), r.uniform(-5, 5, (3, 10)).astype(np.float32),
                       np.array([True, i % 2 == 0, False]), 0.1 * i)
        rec.save(str(tmp_path / f"{tag}_tum.txt"))
        outs.append(sorted(os.path.basename(f)[1:] for f in obj.save(str(tmp_path / f"{tag}_obj"))))
    assert outs[0] == outs[1] == ["_obj_obj3.txt", "_obj_obj7.txt"]
    for f in ("_tum.txt", "_obj_obj3.txt", "_obj_obj7.txt"):
        assert (tmp_path / f"p{f}").read_bytes() == (tmp_path / f"j{f}").read_bytes()


def test_evaldump_is_byte_identical(tmp_path):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text("odomNode:\n  evaluation:\n    evaluate: true\n")
    dirs = []
    for mod, tag in ((evaldump, "p"), (jevaldump, "j")):
        d = mod.EvalDump(str(tmp_path / tag), str(cfg_path), timestamp=1.7e9)
        r = np.random.default_rng(3)
        for i in range(3):
            T = _rng_poses(r, 1)[0] @ np.diag([1, -1, -1, 1.0])
            d.frame(i, np.sort(r.choice(1000, 5, replace=False)), 0.1 * i + 1e-4, T.astype(np.float32))
        dirs.append(d.output_dir)
    assert os.path.basename(dirs[0]) == os.path.basename(dirs[1])
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) == ["0000.txt", "0001.txt", "0002.txt", "cfg.yaml", "poses.txt"]
    for f in names:
        assert open(os.path.join(dirs[0], f), "rb").read() == open(os.path.join(dirs[1], f), "rb").read()


@pytest.mark.parametrize("binary,intensity", [(True, False), (True, True), (False, False), (False, True)])
def test_pcd_writer_is_byte_identical(tmp_path, binary, intensity):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) < 0.7
    inten = rng.uniform(0, 2, 500).astype(np.float32) if intensity else None
    a, b = str(tmp_path / "p.pcd"), str(tmp_path / "j.pcd")
    n_p = pcd.save_pcd(a, pts, mask, intensity=inten, binary=binary)
    n_j = jpcd.save_pcd(b, pts, mask, intensity=inten, binary=binary)
    assert n_p == n_j == mask.sum()
    assert open(a, "rb").read() == open(b, "rb").read()
    (pp, pe), (jp, je) = pcd.load_pcd(a), jpcd.load_pcd(a)
    np.testing.assert_array_equal(pp, jp)
    assert pe.keys() == je.keys()


def test_debug_images_are_byte_identical(tmp_path):
    pytest.importorskip("PIL")
    rng = np.random.default_rng(5)
    rng_img = rng.uniform(0, 40, (16, 64)).astype(np.float32)
    res_img = rng.uniform(0, 1, (16, 64)).astype(np.float32)
    labels = rng.integers(-1, 6, (16, 64)).astype(np.int32)
    for mod, tag in ((viz, "p"), (jviz, "j")):
        mod.save_debug_images(str(tmp_path / tag), 7, rng_img, res_img, labels, dilate_kernel_size=3)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names and names == sorted(os.listdir(tmp_path / "j"))
    for f in names:
        assert (tmp_path / "p" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()


def test_pointcloud2_decoding_matches_jax():
    rng = np.random.default_rng(6)
    n, step = 50, 32
    rec = np.zeros((n, step), np.uint8)
    xyz = rng.uniform(-10, 10, (n, 3)).astype(">f4")
    xyz[::7] = np.nan
    rec[:, 4:16] = xyz.view(np.uint8).reshape(n, 12)
    data = rec.tobytes()
    kw = dict(offsets=(4, 8, 12), is_bigendian=True)
    (pp, pm), (jp, jm) = pointcloud2.decode_scan(data, n, step, **kw), jpc2.decode_scan(data, n, step, **kw)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pm, jm)


# ---------------------------------------------------------------------------
# ate, dashboard, profiling


def test_ate_rmse_matches_jax():
    rng = np.random.default_rng(7)
    gt = _rng_poses(rng, 10)
    est = rng.uniform(-5, 5, (8, 3))
    stamps = np.arange(10) * 0.1
    assert runner.ate_rmse(est, gt) == jrunner.ate_rmse(est, gt)
    kept = stamps[[1, 2, 3, 5, 6, 7, 8, 9]]
    assert runner.ate_rmse(est, gt, kept, stamps) == jrunner.ate_rmse(est, gt, kept, stamps)


def _fed(mod, values):
    prof = mod.Profiler()
    for v in values:
        prof["total"].add(v)
    prof["odometry"].add(values[0])
    prof["extra_stage"].add(values[-1])
    return prof


def test_profiling_statistics_match_jax():
    vals = [3.25, 1.5, 7.0, 2.125, 4.75]
    p, j = _fed(profiling, vals), _fed(jprofiling, vals)
    assert profiling.STAGES == jprofiling.STAGES
    for name in ("total", "odometry", "extra_stage"):
        a, b = p[name], j[name]
        assert (a.n, a.last, a.mean, a.var, a.min, a.max) == (b.n, b.last, b.mean, b.var, b.min, b.max)
        assert a.row() == b.row()
    assert p.dashboard() == j.dashboard()
    assert p["never"].row() == j["never"].row()


def test_device_busy_counts_overlaps_once():
    from types import SimpleNamespace as NS

    def ev(a, b, dev=torch.autograd.DeviceType.CUDA):
        return NS(time_range=NS(start=a, end=b), device_type=dev)

    prof = NS(events=lambda: [ev(10, 20), ev(15, 30), ev(40, 45), ev(0, 100, torch.autograd.DeviceType.CPU)])
    assert profiling.device_busy_us(prof) == (25.0, 3)
    assert profiling.device_busy_us(NS(events=lambda: [])) == (0.0, 0)


def test_dashboard_text_matches_jax():
    vals = [3.25, 1.5, 7.0]
    args = (12, 40, np.array([1.0, -2.5, 0.25]), np.array([1.0, 0.0, 0.0, 0.0]), 7, 12345, 3, 42)
    p = runner.debug_dashboard(_fed(profiling, vals), *args).splitlines()
    j = jrunner.debug_dashboard(_fed(jprofiling, vals), *args).splitlines()
    assert len(p) == len(j)
    # RSS and CPU share are the process's own readings
    volatile = re.compile(r"RSS +[\d.]+ MB|cpu +[\d.]+ %")
    for a, b in zip(p, j):
        assert volatile.sub("#", a) == volatile.sub("#", b)

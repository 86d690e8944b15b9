"""A whole ``cli run`` of the port on the CPU against the JAX CLI's."""

import os

from torch_replay_parity import _seq, assert_text_close

from dynamic_direct_lidar_odometry_tpu import cli as jcli
from dynamic_direct_lidar_odometry_tpu_torch import cli


def test_run_on_the_cpu_matches_the_jax_cli(tmp_path, capsys):
    """A whole ``run`` over tests/test_runner.py's gentle arc, plain DLO
    (the dynamic replay is held in tests/test_torch_runner.py): the same
    stdout summary and artifacts. (The JAX CLI replays with its host
    hulls, the port's with the device hulls, here the blocked ones; with
    fewer than four keyframes both hull sets are empty.)"""
    path = str(tmp_path / "arc.npz")
    _seq(n=4).save(path)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    args = ["run", "--dataset", path, "--quiet", "--save-every", "2", "--no-dynamic"]
    assert jcli.main(args + ["--out", jout]) == 0
    jtext = capsys.readouterr().out
    assert cli.main(args + ["--out", pout, "--device", "cpu"]) == 0
    ptext = capsys.readouterr().out
    summary = [ln for ln in jtext.splitlines() if ln.startswith("scans=")]
    assert summary and summary == [ln for ln in ptext.splitlines() if ln.startswith("scans=")]
    ate = [ln for ln in jtext.splitlines() if ln.startswith("ATE")]
    assert ate == [ln for ln in ptext.splitlines() if ln.startswith("ATE")]
    assert float(ate[0].split()[-2]) < 0.05
    for f in ("trajectory_tum.txt", "trajectory_tum_00002.txt"):
        assert_text_close(os.path.join(jout, f), os.path.join(pout, f), 1e-4)
    assert sorted(os.listdir(jout)) == sorted(os.listdir(pout))

"""The port's replay against the JAX package's in the two other hull
configurations: the host hulls (``hulls="exact"``), and a store of 80
keyframes, where both take the blocked (K > 64) device hulls."""

import dataclasses

from torch_replay_parity import (
    ARTIFACTS, _both, _seq, _small_cfg, assert_results_close, assert_run_files_close,
)

from dynamic_direct_lidar_odometry_tpu_torch.odometry import keyframes as kf


def test_replay_matches_jax_at_80_keyframes(tmp_path):
    seq = _seq(n=5)
    cfg = _small_cfg(seq.H, seq.W)
    cfg = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, max_keyframes=80))
    before = dict(kf.BLOCKED_CALLS)
    jr, pr, jd, pd = _both(cfg, seq, str(tmp_path), hulls="device", **ARTIFACTS)
    assert kf.BLOCKED_CALLS["convex"] > before["convex"]
    assert kf.BLOCKED_CALLS["concave"] > before["concave"]
    assert_results_close(jr, pr)
    assert_run_files_close(jd, pd)


def test_replay_matches_jax_exact_hulls(tmp_path):
    """The host-hull mode: the masks that feed step i come from the
    state after scan i-2 on both sides."""
    seq = _seq(n=4)
    jr, pr, jd, pd = _both(_small_cfg(seq.H, seq.W), seq, str(tmp_path), hulls="exact",
                           **dict(ARTIFACTS, export_clouds_every=2))
    assert_results_close(jr, pr)
    assert_run_files_close(jd, pd)

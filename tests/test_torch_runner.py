"""The port's replay loop (runner.replay) against the JAX package's on
the CPU, on tests/test_runner.py's scenes: the results and every file
the run writes (TUM trajectory, object trajectories, map.pcd and its
snapshots, the evaluation-dump session, tracks.jsonl, the exported
clouds), numerically equal within the tolerances of
tests/torch_replay_parity.py and in the same format."""

import numpy as np
import pytest
import torch

from torch_parity import n
from torch_replay_parity import (
    ARTIFACTS, _both, _seq, _small_cfg, assert_results_close, assert_run_files_close, dynamic_cfg, lean_cfg,
)

from dynamic_direct_lidar_odometry_tpu_torch import runner


@pytest.fixture(scope="module")
def dynamic_run(tmp_path_factory):
    """8 scans in which a mover turns DYNAMIC (object trajectories,
    dynamic pixels, map box removal), device hulls, every artifact on.
    Also counts the port's map box removals."""
    seq = _seq(n=8)
    cfg = dynamic_cfg(lean_cfg(seq))
    calls = []
    real = runner.mapper.remove_boxes

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner.mapper, "remove_boxes", counted)
        out = _both(cfg, seq, str(tmp_path_factory.mktemp("dyn")), hulls="device", **ARTIFACTS)
    return out + (len(calls),)


def test_replay_matches_jax_dynamic_scene(dynamic_run):
    jr, pr, _, _, removals = dynamic_run
    assert jr.dynamic_counts.sum() > 0 and len(jr.object_trajectories.trajs) > 0
    assert removals > 0
    assert_results_close(jr, pr)
    assert sorted(pr.object_trajectories.trajs) == sorted(jr.object_trajectories.trajs)
    assert pr.profiler["total"].n == jr.profiler["total"].n == len(jr.poses)


def test_replay_files_match_jax_dynamic_scene(dynamic_run):
    _, _, jd, pd, _ = dynamic_run
    assert_run_files_close(jd, pd)


def test_replay_map_state_matches_jax(dynamic_run):
    jr, pr, _, _, _ = dynamic_run
    np.testing.assert_array_equal(n(pr.map_state.mask), np.asarray(jr.map_state.mask))
    np.testing.assert_allclose(n(pr.map_state.points), np.asarray(jr.map_state.points), atol=1e-4)
    for f in ("write_ptr", "total_added"):
        assert getattr(pr.map_state, f).dtype == torch.int32
        assert int(getattr(pr.map_state, f)) == int(getattr(jr.map_state, f))


def test_replay_rejects_unknown_hull_source():
    seq = _seq(n=2)
    with pytest.raises(ValueError, match="hulls"):
        runner.replay(_small_cfg(seq.H, seq.W), seq, hulls="qhull", device="cpu")

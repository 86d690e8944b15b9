"""The NaN watchdog of the port's replay (tests/test_runner.py's case): a
non-finite pose rolls the pipelined loop back to the last good state."""

import numpy as np

from torch_parity import n, port_cfg
from torch_replay_parity import _seq, lean_cfg

from dynamic_direct_lidar_odometry_tpu_torch import runner

N_SCANS = 5


def test_nan_watchdog_rolls_back_pipelined_loop(monkeypatch):
    """The third processed scan's pose is poisoned: it is dropped with the
    in-flight step built on it, which is dispatched again against the
    restored state and kept."""
    seq = _seq(n=N_SCANS)
    cfg = lean_cfg(seq)
    real_step = runner.pipeline.step
    calls = {"n": 0}

    def poisoned_step(cfg_, state, pts, mask, ts, hull_masks=None, **kw):
        calls["n"] += 1
        state2, out = real_step(cfg_, state, pts, mask, ts, hull_masks, **kw)
        if calls["n"] == 3:
            bad_T = out.odom.T.clone()
            bad_T[0, 3] = float("nan")
            out = out._replace(odom=out.odom._replace(T=bad_T))
        return state2, out

    monkeypatch.setattr(runner.pipeline, "step", poisoned_step)
    res = runner.replay(port_cfg(cfg), seq, map_capacity=20_000, device="cpu")
    assert res.dropped_scans == 1
    assert len(res.poses) == N_SCANS - 2
    assert np.all(np.isfinite(res.poses))
    assert np.all(np.isfinite(n(res.final_state.odom.T)))
    assert calls["n"] == N_SCANS  # every scan after the first, and the one dispatched again

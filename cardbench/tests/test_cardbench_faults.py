"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU.

Two programs take the timed path's place: a stand-in that integrates the
true motion into its state and reports the truth (so each fault shows
alone, on every number), and the port itself at a tiny size (the pose
faults)."""

from typing import NamedTuple

import numpy as np
import pytest
import torch
from conftest import tiny_cell

import controls
import harness
from reference import judge


class Tracks(NamedTuple):
    active: torch.Tensor
    status: torch.Tensor
    x: torch.Tensor


class State(NamedTuple):
    T: torch.Tensor  # (B, 4, 4) the last pose
    tracks: Tracks


class Odom(NamedTuple):
    T: torch.Tensor


class Out(NamedTuple):
    odom: Odom
    dynamic_mask: torch.Tensor
    keyframe_added: torch.Tensor


def truth_program(feed):
    """The reference in float32 in the program's place: each step moves
    the state's pose by the true motion; the masks and tracks are the
    truth's; a keyframe is flagged 1 m from every earlier one."""
    B = feed.streams
    M = feed.mover_xy.shape[1]
    keyframes = [[feed.poses[i, :3, 3]] for i in feed.lap_index(0)]

    def entry(st, p, m, stamp):
        j = int(round(float(np.asarray(stamp).reshape(-1)[0]) / feed.dt))
        a, b = feed.lap_index(j - 1), feed.lap_index(j)
        G0, G1 = feed.poses[a], feed.poses[b]
        T = st.T.double() @ torch.as_tensor(np.linalg.inv(G0) @ G1)
        x = torch.zeros((B, M, 10))
        x[..., :2] = torch.as_tensor(feed.mover_xy[b], dtype=torch.float32)
        tracks = Tracks(torch.ones((B, M), dtype=torch.bool),
                        torch.full((B, M), judge.DYNAMIC, dtype=torch.int32), x)
        dyn = feed.mover[torch.as_tensor(b)] >= 0
        flag = torch.zeros((B,), dtype=torch.bool)
        for r in range(B):
            t = T[r, :3, 3].numpy()
            if min(np.linalg.norm(k - t) for k in keyframes[r]) > 1.0:
                keyframes[r].append(t)
                flag[r] = True
        one = (lambda x: x.squeeze(0)) if B == 1 else (lambda x: x)
        out = Out(Odom(one(T.float())), one(dyn), one(flag))
        return State(T.float(), tracks), out

    def start():
        T0 = torch.as_tensor(feed.poses[feed.lap_index(0)], dtype=torch.float32)
        return State(T0, Tracks(torch.zeros((B, M), dtype=torch.bool),
                                torch.zeros((B, M), dtype=torch.int32), torch.zeros((B, M, 10))))
    return entry, start


def correct(cell, feed, rec):
    checks = judge.compare(harness.judge_run(cell, feed, rec), cell.limits)
    return harness.failed_scans(rec) == 0 and all(c["ok"] for c in checks.values()), checks


def run_windows(drv, steps, wraps):
    snap = drv.snapshot()
    results = {}
    for name, wrap in wraps.items():
        drv.restore(snap)
        entry = drv.entry
        drv.entry = wrap(entry) if wrap else entry
        drv.begin_window()
        for _ in range(steps):
            drv.step(keep=True)
        drv.entry = entry
        results[name] = drv.rec
    return results


@pytest.mark.parametrize("workload,streams,rows,columns", [
    ("doals.stream1", 1, 16, 256), ("doals.fleet8", 2, 16, 256)])
def test_every_fault_fails_a_stand_in_that_is_correct(workload, streams, rows, columns):
    cell = tiny_cell(workload, rows=rows, columns=columns, lap=48, streams=streams)
    feed = harness.make_feed(cell, 2**35 + 1, "cpu")
    drv = harness.Driver(cell, feed, "cpu")
    entry, start = truth_program(feed)
    drv.entry, drv.state = entry, start()
    for _ in range(len(feed.order) + 1):  # one lap, as set-up drives
        drv.step()
    faults = controls._faults(streams)
    recs = run_windows(drv, len(feed.order), {"sound": None, **faults})  # a lap: every mover seen
    ok, checks = correct(cell, feed, recs["sound"])
    assert ok, checks
    assert checks["dyn_static"]["value"] == 0.0
    for name in faults:
        ok, checks = correct(cell, feed, recs[name])
        assert not ok, (name, checks)


def test_the_port_with_a_pose_fault_is_not_correct():
    cell = tiny_cell("doals.stream1", rows=32, columns=512, lap=336)
    feed = harness.make_feed(cell, 2**40 + 9, "cpu")
    drv = harness.Driver(cell, feed, "cpu")
    for _ in range(2):
        drv.step()
    faults = controls._faults(1)
    recs = run_windows(drv, 3, {"sound": None, "state_unchanged": faults["state_unchanged"],
                                "pose_altered": faults["pose_altered"]})
    sound = harness.judge_run(cell, feed, recs["sound"])
    assert sound["step_mm"] <= cell.limits["step_mm"] and sound["pose_mm"] <= cell.limits["pose_mm"]
    for name in ("state_unchanged", "pose_altered"):
        ok, checks = correct(cell, feed, recs[name])
        assert not ok, (name, checks)

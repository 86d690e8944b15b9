"""The generator: a seed renders the same lap twice, the lap closes in pose
and in movers, and no static box stands within the clearance of the path."""

import numpy as np
import pytest
import torch
from conftest import BENCH

from traffic import generator

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def _small(mix, rows=8, columns=64):
    mix = dict(mix, sensor=dict(mix["sensor"], rows=rows, columns=columns))
    return mix


@pytest.mark.parametrize("name", MIXES)
def test_a_seed_renders_the_same_lap_twice(name):
    mix = _small(generator.load_mix(name))
    seed = 2**33 + 17
    a = generator.render_lap(mix, seed, "cpu", scans=[0, 5, 9])
    b = generator.render_lap(mix, seed, "cpu", scans=[0, 5, 9])
    c = generator.render_lap(mix, seed + 1, "cpu", scans=[0, 5, 9])
    assert torch.equal(torch.nan_to_num(a.points), torch.nan_to_num(b.points))
    assert torch.equal(a.mask, b.mask) and torch.equal(a.mover, b.mover)
    assert not torch.equal(torch.nan_to_num(a.points), torch.nan_to_num(c.points))
    assert generator.start_offset(seed, 336) == generator.start_offset(seed, 336)


@pytest.mark.parametrize("name", MIXES)
def test_the_lap_closes(name):
    mix = generator.load_mix(name)
    T = generator.loop_poses(mix["path"])
    L = len(T)
    steps = [np.linalg.inv(T[i]) @ T[(i + 1) % L] for i in range(L)]
    np.testing.assert_allclose(steps[-1], steps[0], atol=1e-12)  # last into first like any step
    dt = float(mix["dt"])
    t = np.arange(L) * dt
    c0 = generator.mover_centres(mix["movers"], t, L * dt)
    c1 = generator.mover_centres(mix["movers"], t + L * dt, L * dt)
    np.testing.assert_allclose(c0, c1, atol=1e-9)
    jump = np.linalg.norm(np.diff(np.concatenate([c0, c0[:1]]), axis=0), axis=-1)
    assert jump.max() <= max(mix["movers"]["speeds"]) * dt * 1.0001


@pytest.mark.parametrize("name", MIXES)
def test_no_static_box_near_the_path(name):
    mix = generator.load_mix(name)
    sc = generator.build_scene(mix)
    xy = sc.poses[:, :2, 3]
    for lo, hi in zip(sc.box_lo[4:], sc.box_hi[4:]):
        assert generator.footprint_distance(lo[:2], hi[:2], xy).min() >= mix["town"]["clear_margin"]
    for m in range(sc.mover_lo.shape[1]):
        c = 0.5 * (sc.mover_lo[:, m, :2] + sc.mover_hi[:, m, :2])
        assert np.linalg.norm(c[:, None] - xy[None], axis=-1).min() >= 2.0


def test_a_fleet_tiles_the_lap_and_stamps_keep_rising():
    from conftest import tiny_cell

    import harness

    cell = tiny_cell("doals.fleet8", rows=4, columns=32, lap=16, streams=4)
    feed = harness.make_feed(cell, 5, "cpu")
    for j in range(40):
        p, m = feed.scan(j)
        idx = feed.lap_index(j)
        assert sorted((idx - idx[0]) % 16) == [0, 4, 8, 12]
        lap = generator.render_lap(cell.mix, 5, "cpu", scans=list(idx))
        assert torch.equal(torch.nan_to_num(p), torch.nan_to_num(lap.points))
        assert torch.equal(m, lap.mask)
    drv = type("D", (), {"feed": feed, "torch": torch})()
    stamps = [float(harness.Driver.stamp(drv, j)[0]) for j in range(1, 60)]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))

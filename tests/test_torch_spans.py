"""The port's tracing (``utils/profiling.py``): device spans in the step
(``profiling.mark``, ``csrc/trace.cu``), host spans in the entries
(``profiling.span``), the one switch (``profiling.device_counts``), the
host log's mapping onto a profiler session, and GICP's ``lm_trials``
count.

On the CPU a stamp reads the host clock, so the step's spans, their rows
and the switch are held here at a tiny size. The ``gpu`` cases skip
without a card: the stamp kernel in a captured graph with conditional
bodies, and the clock check (host spans against the profiler's
``cudaGraphLaunch`` events, each stamp's ``%globaltimer`` against its
kernel's CUPTI interval). This module imports no JAX, so they run on a
host without it: ``python -m pytest --noconftest tests/test_torch_spans.py
-m gpu``.
"""

from __future__ import annotations

import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch

from dynamic_direct_lidar_odometry_tpu_torch import config, pipeline, runner
from dynamic_direct_lidar_odometry_tpu_torch.core import control
from dynamic_direct_lidar_odometry_tpu_torch.io import dataset
from dynamic_direct_lidar_odometry_tpu_torch.ops import gicp
from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding
from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

STAGES = profiling.STAGE_SPANS


def tiny_cfg(dynamic: bool = True):
    cfg = config.doals_config()
    return dataclasses.replace(
        cfg,
        dynamic_detection=dynamic,
        detection=dataclasses.replace(cfg.detection, rows=16, columns=128, ground_rows=4),
        capacity=config.CapacityConfig(
            max_points=512, max_submap_points=2048, max_keyframes=8,
            max_keyframe_points=512, max_objects=4, max_tracks=4, nn_chunk=128,
        ),
    )


def _seq(seed=0, n=4):
    return dataset.synthetic_sequence(n_scans=n, H=16, W=128, n_dynamic=1, seed=seed)


def _span_keys(counts):
    return {k for k in counts if k.startswith(("span.", "host."))}


@pytest.mark.parametrize("dynamic", [True, False])
def test_traced_step_records_every_span(dynamic):
    cfg, q = tiny_cfg(dynamic), _seq()
    st = pipeline.init_state(cfg, q.points[0], q.mask[0], 0.0, device="cpu")
    steps = 3
    with profiling.device_counts("cpu") as c:
        for i in range(1, 1 + steps):
            st, _ = pipeline.step(cfg, st, q.points[i], q.mask[i], float(q.stamps[i]))
    stages = STAGES if dynamic else ("preprocess", "covariances", "s2s", "submap", "s2m", "keyframes")
    nested = profiling.DETECTION_SPANS if dynamic else ()
    want = {f"span.{s}.{x}" for s in ("graph",) + stages + nested for x in ("ns", "n")}
    assert _span_keys(c) == want | {"host.entry.prepare.ns", "host.entry.prepare.n"}
    assert all(c[f"span.{s}.n"] == steps for s in ("graph",) + stages + nested)
    # a stamp a stage edge and two for the graph: 10 edges, 8 without the
    # detector; 4 more for the detector's three nested spans
    assert c["span"] == steps * (16 if dynamic else 10)
    assert c["host.entry.prepare.n"] == steps
    stage_ns = sum(c[f"span.{s}.ns"] for s in stages)
    assert 0 < stage_ns <= c["span.graph.ns"]
    # on the host clock the operations between stages are a small part
    assert stage_ns >= 0.9 * c["span.graph.ns"]


@pytest.mark.parametrize("grid", ["lidar", "camera"])
def test_detection_sub_spans_nest_in_detection(grid):
    """``detection.project``, ``detection.ccl`` and ``detection.objects``
    close once a scan, as ``detection`` does, and together take no more
    than it, on a LiDAR ring and on the camera grid."""
    cfg, q = tiny_cfg(), _seq()
    cfg = dataclasses.replace(cfg, detection=dataclasses.replace(cfg.detection, residual_grid=grid))
    st = pipeline.init_state(cfg, q.points[0], q.mask[0], 0.0, device="cpu")
    steps = 3
    with profiling.device_counts("cpu") as c:
        for i in range(1, 1 + steps):
            st, _ = pipeline.step(cfg, st, q.points[i], q.mask[i], float(q.stamps[i]))
    assert all(c[f"span.{s}.n"] == c["span.detection.n"] == steps for s in profiling.DETECTION_SPANS)
    parts = [c[f"span.{s}.ns"] for s in profiling.DETECTION_SPANS]
    assert all(p > 0 for p in parts) and sum(parts) <= c["span.detection.ns"]


def test_nothing_is_recorded_outside_device_counts():
    cfg, q = tiny_cfg(), _seq(1)
    st = pipeline.init_state(cfg, q.points[0], q.mask[0], 0.0, device="cpu")
    with profiling.device_counts("cpu"):
        pass
    assert not profiling._T.on
    profiling.counts_buffer("cpu").zero_()
    st, _ = pipeline.step(cfg, st, q.points[1], q.mask[1], float(q.stamps[1]))
    with profiling.span("outside"):
        pass
    assert profiling.host_log() == []
    buf = profiling.counts_buffer("cpu").sum(dim=0)
    spans = [i for k, i in profiling._SLOTS.items() if k.startswith("span.")]
    assert spans and not buf[spans].any()
    with profiling.device_counts("cpu") as c:
        pass
    assert not _span_keys(c)


def test_branch_rows_sum():
    cfg, B, S = tiny_cfg(), 2, 3
    seqs = [_seq(b, S) for b in range(B)]
    pts, msk = np.stack([q.points for q in seqs]), np.stack([q.mask for q in seqs])
    ts = np.stack([q.stamps for q in seqs]).astype(np.float32)
    states = sharding.batched_init_state(cfg, pts[:, 0], msk[:, 0], ts[:, 0], device="cpu")
    step = sharding.batched_pipeline_step(cfg, sharding.make_mesh(1, devices=["cpu"]))
    with profiling.device_counts("cpu") as c:
        for s in range(1, S):
            states, _ = step(states, pts[:, s], msk[:, s], ts[:, s])
        # a stamp in a row of its own, as a graph branch makes one
        with profiling.count_row(5):
            profiling.mark("cpu", begin="row5")
            profiling.mark("cpu", end="row5")
        profiling.mark("cpu", begin="row5")
        profiling.mark("cpu", end="row5")
    assert c["span.graph.n"] == S - 1  # one body a step, in row 0
    assert all(c[f"span.{s}.n"] == B * (S - 1) for s in STAGES)  # one a stream-scan
    assert c["span.row5.n"] == 2
    assert c["host.entry.prepare.n"] == S - 1


def test_a_close_without_its_open_counts_nothing():
    with profiling.device_counts("cpu") as c:
        profiling.mark("cpu", end="never_opened")
        profiling.mark("cpu", begin="twice")
        profiling.mark("cpu", end="twice")
        profiling.mark("cpu", end="twice")  # the open time was used
    assert "span.never_opened.n" not in c and c["span.twice.n"] == 1


@pytest.mark.parametrize("on", [False, True])
def test_host_span_records_only_while_tracing(on):
    s = profiling.span("unit")
    if on:
        with profiling.device_counts("cpu") as c:
            with s:
                time.sleep(0.002)
            with s:
                pass
        assert c["host.unit.n"] == 2 and c["host.unit.ns"] >= 2_000_000
        assert [n for n, _, _ in profiling.host_log()] == ["unit", "unit"]
    else:
        with profiling.device_counts("cpu"):
            pass
        with s:
            time.sleep(0.001)
        assert profiling.host_log() == [] and not profiling._T.on
        with profiling.device_counts("cpu") as c:
            pass
        assert "host.unit.n" not in c


def test_switch_nests_and_interval_zeroes():
    with profiling.device_counts("cpu") as outer:
        with profiling.span("a"):
            pass
        first = profiling.interval("cpu")
        with profiling.device_counts("cpu"):
            pass
        assert profiling._T.on  # the outer block is still on
        with profiling.span("a"):
            pass
    assert first["host.a.n"] == 1 and outer["host.a.n"] == 1
    assert not profiling._T.on


def test_host_log_maps_onto_a_synthetic_profiler_time_base():
    base = 1_700_000_000_000_000_000
    log = [("entry.launch", base + 5_000, base + 12_500), ("entry.clone", base + 13_000, base + 13_001)]
    res = types.SimpleNamespace(trace_start_ns=lambda: base)
    # torch.profiler.profile holds the autograd profiler, which holds the results
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=res))
    assert profiling.on_profile(prof, log) == [("entry.launch", 5.0, 12.5), ("entry.clone", 13.0, 13.001)]
    assert profiling.on_profile(types.SimpleNamespace(kineto_results=res), log[:1]) == [("entry.launch", 5.0, 12.5)]


def test_host_log_maps_onto_a_real_cpu_profile():
    """The host clock is the profiler's: an op recorded inside a host span
    lies inside the mapped span."""
    x = torch.ones(1 << 16)
    with profiling.device_counts("cpu"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for _ in range(3):
                with profiling.span("around_cos"):
                    torch.cos(x)
                time.sleep(0.001)
    spans = profiling.on_profile(prof)
    ops = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if e.name == "aten::cos")
    assert len(spans) == len(ops) == 3
    for (_, a, b), (s, e) in zip(spans, ops):
        assert a <= s and e <= b, (a, b, s, e)


def _lm_case():
    g = torch.Generator().manual_seed(3)
    N = 384
    src = torch.randn((N, 3), generator=g) * torch.tensor([4.0, 4.0, 1.0])
    c = torch.tensor([[0.05, 0.0, 0.0], [0.0, 0.05, 0.0], [0.0, 0.0, 0.01]]).expand(N, 3, 3).contiguous()
    T = torch.eye(4)
    T[:3, 3] = torch.tensor([0.3, -0.2, 0.05])
    tgt = src @ T[:3, :3].T + T[:3, 3]
    mask = torch.ones(N, dtype=torch.bool)
    return src, mask, c, tgt, mask.clone(), c.clone(), torch.eye(4)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("arith", ["xla_host", "card"])
def test_lm_trials_equal_the_loops_j(arith, batched, monkeypatch):
    """``lm_trials`` is the sum of every lambda loop's ``j``: the trials
    of the host loop (one ``lm_decide`` each), or each stream's ``j``
    of the card's whole-loop call."""
    args = _lm_case()
    if batched:
        args = tuple(torch.stack([a, a]) for a in args)
    s = gicp.GICPSettings(max_iterations=6, nn_impl="exact", max_correspondence_distance=2.0)
    ar = gicp.TORCH if arith == "card" else gicp.arithmetic(torch.device("cpu"))
    trials = []
    if arith == "card":
        real = ar.lm_inner

        def recorded(*a):
            st = real(*a)
            trials.append(int(st.j.sum()))
            return st

        ar = types.SimpleNamespace(**{**vars(ar), "lm_inner": recorded})
    else:
        real_decide = ar.lm_decide

        def decide(y0, yi, d, b, delta, xi, st, s_):
            trials.append(1)
            return real_decide(y0, yi, d, b, delta, xi, st, s_)

        ar = types.SimpleNamespace(**{k: getattr(ar, k) for k in dir(ar) if not k.startswith("__")})
        ar.lm_decide = decide
    monkeypatch.setattr(gicp, "arithmetic", lambda dev: ar)
    with profiling.device_counts("cpu") as c:
        res = (gicp.align_batch if batched else gicp.align)(*args, s)
    assert int(res.iterations.max()) >= 1
    assert sum(trials) > 0 and c["lm_trials"] == sum(trials)


def test_graph_call_spans_its_parts():
    """``Graph.__call__`` as the host spans ``entry.copy_in``,
    ``entry.launch`` (the replay) and ``entry.clone``, one after another
    (a stub in place of the captured graph)."""
    g = control.Graph.__new__(control.Graph)
    g.static_in = (torch.zeros(4), 3)
    g.static_out = (torch.ones(4),)
    g.replays = 0
    g.graph = types.SimpleNamespace(replay=lambda: time.sleep(0.002))
    with profiling.device_counts("cpu") as c:
        out = g(torch.full((4,), 2.0), 3)
    assert torch.equal(g.static_in[0], torch.full((4,), 2.0)) and torch.equal(out[0], torch.ones(4))
    assert all(c[f"host.entry.{p}.n"] == 1 for p in ("copy_in", "launch", "clone"))
    assert c["host.entry.launch.ns"] >= 2_000_000
    log = profiling.host_log()
    assert [n for n, _, _ in log] == ["entry.copy_in", "entry.launch", "entry.clone"]
    assert all(a[2] <= b[1] for a, b in zip(log, log[1:]))


def test_dashboard_stage_rows_read_the_spans():
    prof = profiling.Profiler()
    spans = {f"span.{s}.ns": 1_000_000 * (k + 1) for k, s in enumerate(STAGES)}
    spans.update({f"span.{s}.n": 2 for s in STAGES})
    spans.update({"host.runner.finalize.ns": 9_000_000, "host.runner.finalize.n": 3})
    runner.stage_rows(prof, spans)
    assert prof["odometry"].last == pytest.approx((1 + 2 + 3 + 4 + 5) / 2)
    assert prof["dynamic"].last == pytest.approx((6 + 7) / 2)
    assert prof["trackDetections"].last == pytest.approx(7 / 2)
    assert prof["finalize"].last == pytest.approx(3.0)
    runner.stage_rows(prof, {})
    assert prof["odometry"].n == prof["finalize"].n == 1 and prof["projectScan"].n == 0
    assert "finalize" in prof.dashboard()


def test_split_reads_a_blocks_spans():
    """``profiling.split``: stage ms a stream-scan, graph ms a replay,
    the stages of a step over its graph, entry ms a step, trials."""
    counts = {f"span.{s}.ns": 1_000_000 for s in STAGES}
    counts.update({"span.graph.ns": 10_000_000, "span.graph.n": 2, "lm_trials": 6})
    counts.update({f"host.{p}.ns": 500_000 * (k + 1) for k, p in enumerate(profiling.ENTRY_SPANS)})
    counts["host.entry.launch.n"] = 2
    got = profiling.split(counts, 4)  # 2 steps of 2 streams
    assert got["stage_device_ms_per_stream_scan"] == {s: 0.25 for s in STAGES}
    assert got["graph_device_ms"] == 5.0
    assert got["stages_over_graph"] == pytest.approx(8 * 0.25 * 2 / 5.0)
    assert got["entry_host_ms_per_step"] == pytest.approx({"entry.prepare": 0.25, "entry.copy_in": 0.5,
                                                           "entry.launch": 0.75, "entry.clone": 1.0})
    assert got["lm_trials_per_stream_scan"] == 1.5
    empty = profiling.split({}, 4)
    assert empty["graph_device_ms"] is None and empty["entry_host_ms_per_step"] is None


def test_runner_dashboard_fills_its_stage_rows(capsys):
    cfg, q = tiny_cfg(), _seq(2, 5)
    res = runner.replay(cfg, q, device="cpu", dashboard_every=2, map_capacity=20_000)
    assert res.profiler["odometry"].n == 2 and res.profiler["trackDetections"].n == 2
    assert res.profiler["dynamic"].mean > res.profiler["trackDetections"].mean > 0
    assert res.profiler["finalize"].n == 2 and res.profiler["finalize"].mean > 0
    assert not profiling._T.on
    assert {n for n, _, _ in profiling.host_log()} == {"entry.prepare", "runner.finalize"}
    assert "odometry" in capsys.readouterr().out


# ---------------------------------------------------------------- the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _turns_fn(x, limit):
    """A WHILE whose body stamps a span each turn, and an IF that stamps
    one when it runs."""
    dev = x.device
    k = torch.zeros((), dtype=torch.int32, device=dev)

    def body():
        profiling.mark(dev, begin="turn")
        x.mul_(1.5)
        profiling.mark(dev, end="turn")
        k.add_(1)

    control.while_loop(lambda: control.Test(k, 64, all_of=(k < limit,)), body, ())

    def once():
        profiling.mark(dev, begin="taken")
        x.add_(1.0)
        profiling.mark(dev, end="taken")

    control.cond(limit > 2, once, None)
    return x.clone()


@pytest.mark.gpu
def test_stamp_kernel_in_a_captured_graph_with_conditional_bodies():
    dev = _card()
    x = torch.ones(1024, device=dev)
    g = None
    for limit in (1, 3, 5):
        lim = torch.tensor(limit, dtype=torch.int32, device=dev)
        g = g or control.Graph(_turns_fn, (x, lim))
        with profiling.device_counts(dev) as c:
            g(x, lim)
        assert c["span.turn.n"] == limit and c["span.graph.n"] == 1
        assert c["span"] == 2 + 2 * limit + 2 * int(limit > 2)  # every stamp counts itself
        assert c.get("span.taken.n", 0) == int(limit > 2)
        assert 0 < c["span.turn.ns"] < c["span.graph.ns"]
    # tracing off: the gate stops every stamp (the counts and open times stay as the block left them)
    before = profiling.counts_buffer(dev).clone(), profiling._OPENED[str(dev)].clone()
    g(x, lim)
    torch.cuda.synchronize()
    slots = [i for k, i in profiling._SLOTS.items() if k.startswith("span")]
    assert torch.equal(profiling.counts_buffer(dev)[:, slots], before[0][:, slots])
    assert torch.equal(profiling._OPENED[str(dev)], before[1])


def _stamps_fn(x):
    """Eight stamps, each opening a span of its own (kept open, so its
    open time, the stamp's timer value, can be read after the replay)."""
    for k in range(8):
        profiling.mark(x.device, begin=f"clock{k}")
        for _ in range(3):
            x.mul_(1.0001)
    return x.clone()


@pytest.mark.gpu
def test_clock_check_host_spans_and_device_stamps_on_the_profiler_clock():
    """Host spans: every step's ``cudaGraphLaunch`` (the profiler's event)
    inside its mapped ``entry.launch`` span. Device stamps: each stamp's
    ``%globaltimer`` value inside its kernel's CUPTI interval, within 2 us,
    once one offset is applied. Prints the timer's resolution: the
    greatest common divisor of the differences between the stamps' values."""
    dev = _card()
    cfg, q = tiny_cfg(), _seq(4, 8)
    st = pipeline.init_state(cfg, q.points[0], q.mask[0], 0.0, device=dev)
    st, _ = pipeline.step(cfg, st, q.points[1], q.mask[1], float(q.stamps[1]))  # captures
    x = torch.ones(1 << 16, device=dev)
    g = control.Graph(_stamps_fn, (x,))
    slots = [profiling._SLOTS[f"span.clock{k}.ns"] for k in range(8)]
    timers = []
    torch.cuda.synchronize()
    with profiling.device_counts(dev):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(2, 8):
                st, out = pipeline.step(cfg, st, q.points[i], q.mask[i], float(q.stamps[i]))
                out.odom.T.cpu()
            for _ in range(4):
                g(x)
                torch.cuda.synchronize()
                timers.append(profiling._OPENED[str(dev)][0, slots].tolist())
    launches = sorted(e.time_range.start for e in prof.events() if e.name == "cudaGraphLaunch"
                      and e.device_type == torch.autograd.DeviceType.CPU)
    spans = [(a, b) for n, a, b in profiling.on_profile(prof) if n == "entry.launch"]
    assert len(spans) == len(launches) == 6 + 4
    for (a, b), t in zip(spans, launches):
        assert a <= t <= b, (a, t, b)

    # in integer ns since the session's start (a double holds Unix-epoch ns to 256 ns only)
    base = prof.profiler.kineto_results.trace_start_ns()
    kernels = sorted((round(1e3 * e.time_range.start), round(1e3 * e.time_range.end)) for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA and "span_kernel" in e.name)
    # the last four replays are _stamps_fn's: the graph span's open, eight stamps, its close
    mine = kernels[-4 * 10:]
    pairs = [(t - base, mine[10 * r + 1 + k]) for r, row in enumerate(timers) for k, t in enumerate(row)]
    offsets = sorted(t - (s + e) // 2 for t, (s, e) in pairs)
    off = offsets[len(offsets) // 2]
    worst = max(max(s - (t - off), (t - off) - e, 0) for t, (s, e) in pairs)
    print(f"stamps vs their kernels: offset {off:.0f} ns, worst outside the interval {worst:.0f} ns")
    assert worst <= 2000
    stamps = sorted(t for row in timers for t in row)
    steps = [b - a for a, b in zip(stamps, stamps[1:])]
    tick = math.gcd(*steps)
    print(f"globaltimer resolution: {tick} ns (gcd of {len(steps)} differences; least {min(steps)} ns)")
    assert 0 < tick <= 1000

"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
builds the deployment's configuration, renders the traffic, drives the
program through the entries users call, and records what the window saw.

A cell ``W`` of ``BENCHMARK.json``'s ``workloads`` names a configuration
``C`` and a traffic mix ``M``:

- ``configs[C].file``: the deployment (``cardbench/deployments/``): the
  port's configuration as it is run, whole, under ``config``;
- ``cardbench/traffic/M.json``: the mix, read by ``traffic/generator.py``;
- ``cardbench/limits/W.json``: the limit of each number the reference
  compares;
- ``cardbench/metrics/<name>.py``: each per-layer metric's reader.

Nothing here knows a cell, a mix or a metric by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import time
import typing
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ---------------------------------------------------------------- the files


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    deployment: dict
    mix: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def resolve(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name``'s files, found by the names ``BENCHMARK.json`` gives."""
    from traffic import generator

    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        deployment = json.load(f)
    mix = generator.load_mix(w["traffic"], root / "cardbench" / "traffic")
    with open(root / "cardbench" / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    return Cell(name, w, deployment, mix, limits, bench["end_to_end"], bench["per_layer"])


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read`` of ``cardbench/metrics/<name>.py``."""
    path = root / "cardbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _tupled(v):
    return tuple(_tupled(x) for x in v) if isinstance(v, list) else v


def _build(cls, d: dict):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        t, v = hints[f.name], d[f.name]
        kw[f.name] = _build(t, v) if dataclasses.is_dataclass(t) else _tupled(v)
    return cls(**kw)


def build_config(deployment: dict):
    """The port's ``DDLOConfig`` from the deployment's ``config``, every
    field as the file states it."""
    from dynamic_direct_lidar_odometry_tpu_torch.config import DDLOConfig

    return _build(DDLOConfig, deployment["config"])


# ---------------------------------------------------------------- the feed


@dataclasses.dataclass
class Feed:
    """The rendered lap in host memory, laid out so that each step's scans
    are one contiguous view, and the truth the reference needs."""

    points: "object"  # torch (L, N, 3) or (s, 2B, N, 3), pinned on a card
    mask: "object"
    order: np.ndarray  # (L,) lap scan of the run's i-th scan
    streams: int
    spacing: int
    dt: float
    poses: np.ndarray  # (L, 4, 4) truth
    valid: "object"  # (L, N) bool on the device: a return
    mover: "object"  # (L, N) int8 on the device: the mover the return hit, -1 none
    visible: "object"  # (L, N) bool on the device: mover returns the detector can see
    mover_xy: np.ndarray  # (L, M, 2) movers' centres

    @property
    def lap(self) -> int:
        return len(self.order)

    def lap_index(self, j: int) -> np.ndarray:
        """(B,) the lap scan each stream sees at step j."""
        return self.order[(j + self.spacing * np.arange(self.streams)) % self.lap]

    def scan(self, j: int):
        """Step j's scans as views of host memory: (N, 3), (N,) for one
        stream, (B, N, 3), (B, N) for B."""
        if self.streams == 1:
            a = j % self.lap
            return self.points[a], self.mask[a]
        a, q = j % self.spacing, (j // self.spacing) % self.streams
        return self.points[a, q:q + self.streams], self.mask[a, q:q + self.streams]


def make_feed(cell: Cell, seed: int, device) -> Feed:
    """Render the lap on ``device``, copy it once into (pinned) host
    memory in the run's order, and keep the truth on the device."""
    import torch

    from reference import judge
    from traffic import generator

    mix = cell.mix
    lap = generator.render_lap(mix, seed, device)
    L, N = lap.points.shape[:2]
    B = int(mix.get("streams", 1))
    s = int(mix.get("stream_spacing", 0)) or L
    if B > 1 and s * B != L:
        raise ValueError(f"{cell.name}: {B} streams {s} scans apart do not tile a lap of {L}")
    order = (generator.start_offset(seed, L) + np.arange(L)) % L
    pin = torch.device(device).type == "cuda"
    if B == 1:
        slots = [order]
        pts = torch.empty((L, N, 3), dtype=torch.float32, pin_memory=pin)
        msk = torch.empty((L, N), dtype=torch.bool, pin_memory=pin)
    else:  # slot (a, k) holds the run's scan a + s (k mod B): two turns of B
        slots = [order[np.arange(s) + s * (k % B)] for k in range(2 * B)]
        pts = torch.empty((s, 2 * B, N, 3), dtype=torch.float32, pin_memory=pin)
        msk = torch.empty((s, 2 * B, N), dtype=torch.bool, pin_memory=pin)
    for k, idx in enumerate(slots):
        i = torch.as_tensor(idx, device=lap.points.device)
        dst_p = pts if B == 1 else pts[:, k]
        dst_m = msk if B == 1 else msk[:, k]
        dst_p.copy_(lap.points.index_select(0, i))
        dst_m.copy_(lap.mask.index_select(0, i))
    det = cell.deployment["config"]["detection"]
    visible = judge.visible_movers(lap.points, lap.mover, det)
    sc = lap.scene
    mover_xy = 0.5 * (sc.mover_lo + sc.mover_hi)[..., :2]
    return Feed(pts, msk, order, B, s, float(mix["dt"]), sc.poses, lap.mask, lap.mover, visible,
                mover_xy)


# ---------------------------------------------------------------- driving


@dataclasses.dataclass
class Record:
    """What the run saw, step by step (set-up included)."""

    T: List[np.ndarray] = dataclasses.field(default_factory=list)  # (B, 4, 4) host poses
    flags: List[object] = dataclasses.field(default_factory=list)  # (B,) device bools
    lap_idx: List[np.ndarray] = dataclasses.field(default_factory=list)
    dynamic: Dict[int, object] = dataclasses.field(default_factory=dict)  # step -> (B, N)
    tracks: Dict[int, tuple] = dataclasses.field(default_factory=dict)  # step -> (active, status, xy)
    latency_s: List[float] = dataclasses.field(default_factory=list)  # window steps
    entry_s: List[float] = dataclasses.field(default_factory=list)
    window_first: int = 0
    window_s: float = 0.0

    def judged(self, lap: int) -> range:
        """The steps the reference judges: the window's first lap, the
        same scans whatever the program's speed."""
        return range(self.window_first, self.window_first + lap)


class Driver:
    """Drives the program for one cell: ``pipeline.step`` for one stream,
    ``parallel.sharding.batched_pipeline_step`` for a fleet."""

    def __init__(self, cell: Cell, feed: Feed, device):
        import torch

        from dynamic_direct_lidar_odometry_tpu_torch import pipeline
        from dynamic_direct_lidar_odometry_tpu_torch.core import tree
        from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding

        self.torch, self.feed, self.dev = torch, feed, torch.device(device)
        self.cfg = build_config(cell.deployment)
        self.rec = Record()
        p, m = feed.scan(0)
        idx = feed.lap_index(0)
        if feed.streams == 1:
            self.state = pipeline.init_state(self.cfg, p, m, 0.0, T0=feed.poses[idx[0]], device=self.dev)
            self.entry = lambda st, p, m, t: pipeline.step(self.cfg, st, p, m, t)
        else:
            self.state = tree.stack([
                pipeline.init_state(self.cfg, p[r], m[r], 0.0, T0=feed.poses[idx[r]], device=self.dev)
                for r in range(feed.streams)])
            self.entry = sharding.batched_pipeline_step(self.cfg, sharding.make_mesh(devices=[self.dev]))
        self.rec.T.append(np.asarray(feed.poses[idx], dtype=np.float64))  # T0, the truth
        self.rec.flags.append(torch.ones(feed.streams, dtype=torch.bool, device=self.dev))
        self.rec.lap_idx.append(idx)
        self.j = 1
        self.kept = None

    def begin_window(self) -> None:
        """The window starts at the next step: device buffers for the
        judged steps' masks and tracks, made now so that the window
        allocates no device memory (a kept output would)."""
        self.rec.window_first = self.j
        torch, B, L = self.torch, self.feed.streams, self.feed.lap
        N = self.feed.points.shape[-2]
        T = self.state.tracks.status.shape[-1]
        dev = dict(device=self.dev)
        self.kept = dict(
            dynamic=torch.zeros((L, B, N), dtype=torch.bool, **dev),
            active=torch.zeros((L, B, T), dtype=torch.bool, **dev),
            status=torch.zeros((L, B, T), dtype=torch.int32, **dev),
            xy=torch.zeros((L, B, T, 2), dtype=torch.float32, **dev))

    def _keep(self, j: int, out) -> None:
        if j not in self.rec.judged(self.feed.lap):
            return
        i, k = j - self.rec.window_first, self.kept
        B, tr = self.feed.streams, self.state.tracks
        k["dynamic"][i].copy_(out.dynamic_mask.reshape(B, -1))
        k["active"][i].copy_(tr.active.reshape(B, -1))
        k["status"][i].copy_(tr.status.reshape(B, -1))
        k["xy"][i].copy_(tr.x[..., :2].reshape(B, -1, 2))
        self.rec.dynamic[j] = k["dynamic"][i]
        self.rec.tracks[j] = (k["active"][i], k["status"][i], k["xy"][i])

    def stamp(self, j: int):
        t = self.feed.dt * j
        if self.feed.streams == 1:
            return t
        return self.torch.full((self.feed.streams,), t, dtype=self.torch.float32)

    def step(self, keep: bool = False):
        """One step through the entry; the pose read on the host. Returns
        (entry seconds, latency seconds)."""
        j = self.j
        p, m = self.feed.scan(j)
        stamp = self.stamp(j)
        t0 = time.perf_counter()
        self.state, out = self.entry(self.state, p, m, stamp)
        t1 = time.perf_counter()
        T = out.odom.T.cpu()
        t2 = time.perf_counter()
        B = self.feed.streams
        self.rec.T.append(T.double().numpy().reshape(B, 4, 4))
        self.rec.flags.append(out.keyframe_added.reshape(B))
        self.rec.lap_idx.append(self.feed.lap_index(j))
        if keep:
            self._keep(j, out)
        self.j += 1
        return t1 - t0, t2 - t0

    def setup(self) -> None:
        """The capture (the first step), then one whole lap."""
        for _ in range(self.feed.lap + 1):
            self.step()

    def window(self, seconds: float) -> None:
        """Steps until ``seconds`` have passed, each step's latency kept;
        then, untimed, any judged step the window did not reach (a slow
        program is judged on the same scans as a fast one)."""
        rec = self.rec
        self.begin_window()
        t_begin = time.perf_counter()
        deadline = t_begin + seconds
        t_last = t_begin
        while time.perf_counter() < deadline:
            e, lat = self.step(keep=True)
            rec.entry_s.append(e)
            rec.latency_s.append(lat)
            t_last = time.perf_counter()
        rec.window_s = t_last - t_begin
        while self.j < rec.judged(self.feed.lap).stop:
            self.step(keep=True)

    def traced(self, stream_scans: int):
        """A profiled stretch of ``ceil(stream_scans / B)`` steps after the
        window, with the program's device counts over it (nothing kept:
        no device work of the harness in the trace). The profiler records
        the card's operations and the host's CUDA calls only, so that its
        cost to the host stays small. Returns the profiler, the counts and
        the stretch's stream-scans."""
        torch = self.torch
        from dynamic_direct_lidar_odometry_tpu_torch.utils import profiling

        steps = -(-stream_scans // self.feed.streams)
        torch.cuda.synchronize()
        with profiling.device_counts(self.dev) as counts:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    self.step()
        return prof, dict(counts), steps * self.feed.streams

    def snapshot(self) -> tuple:
        """The state, the step and the record so far, to start more
        windows from the same place."""
        from dynamic_direct_lidar_odometry_tpu_torch.core import tree

        return tree.map_leaves(self.torch.clone, self.state), self.j, len(self.rec.T)

    def restore(self, snap: tuple) -> None:
        from dynamic_direct_lidar_odometry_tpu_torch.core import tree

        state, self.j, n = snap
        self.state = tree.map_leaves(self.torch.clone, state)
        rec = self.rec
        self.rec = Record(T=rec.T[:n], flags=rec.flags[:n], lap_idx=rec.lap_idx[:n])

    def graph_stats(self) -> list:
        from dynamic_direct_lidar_odometry_tpu_torch import pipeline
        from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding

        return pipeline.graph_stats() + sharding.graph_stats()

    def release(self) -> None:
        """Free the program's state and graphs (before the reference runs)."""
        from dynamic_direct_lidar_odometry_tpu_torch import pipeline
        from dynamic_direct_lidar_odometry_tpu_torch.parallel import sharding

        self.state = None
        pipeline.clear_graphs()
        sharding.clear_graphs()


# ---------------------------------------------------------------- judging


def judge_run(cell: Cell, feed: Feed, rec: Record) -> Dict[str, Optional[float]]:
    """The reference's numbers for a run's judged steps (the window's
    first lap)."""
    import torch

    from reference import judge

    first, end = rec.judged(feed.lap).start, rec.judged(feed.lap).stop
    P = np.stack(rec.T)[:end]
    F = torch.stack(rec.flags).cpu().numpy()[:end]
    idx = np.stack(rec.lap_idx)[:end]
    G = feed.poses[idx]
    numbers = judge.pose_numbers(P, G, first)
    thresh_rot = float(cell.deployment["config"]["keyframe"]["thresh_rot"])
    numbers["kf_wrong"] = float(sum(judge.keyframe_contradictions(P[:, b], F[:, b], first, thresh_rot)
                                    for b in range(P.shape[1])))
    j = judge.Judge(feed.valid, feed.mover, feed.visible, feed.mover_xy)
    for step in sorted(rec.dynamic):
        act, st, xy = (t.cpu().numpy() for t in rec.tracks[step])
        j.add(idx[step], rec.dynamic[step], act, st, xy)
    numbers.update(j.masks())
    return numbers


def failed_scans(rec: Record) -> int:
    """Stream-scans from the window's start on whose pose is not finite."""
    P = np.stack(rec.T[rec.window_first:])
    return int((~np.isfinite(P).all(axis=(2, 3))).sum())

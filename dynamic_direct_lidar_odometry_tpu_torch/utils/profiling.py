"""Per-stage profiling with the reference's stage taxonomy (counterpart
of ``utils/profiling.py``), and the port's tracing: counts and spans on
the device, spans on the host.

Re-design of ``util/accumulator.h`` (``AccumulatorData``: accumulators
with last/mean/var/min/max, accumulator.h:15-52) and the console
dashboard ``OdomNode::debug`` (odom.cc:1317-1461). Stage names match the
reference so profiles line up:

  total, odometry, dynamic                       (odom.cc:189-192)
  projectScan, projectResiduals, groundRemoval,
  cloudSegmentation, computeAllObjects, trackDetections
                                                 (detection.cpp:64-69)

Tracing. :func:`count` counts calls on the device, always, so that work
replayed inside a captured graph is counted as it runs. Spans are
recorded only while tracing is on, and :func:`device_counts` is its one
switch: on for its block (in stream order), off after it. Its dict holds
the counts and the spans' sums:

- ``span.<name>.ns`` / ``span.<name>.n``: device spans, stamped by
  :func:`mark` (``csrc/trace.cu``: a one-thread kernel that reads
  ``%globaltimer``, a node of a captured graph like :func:`count`'s add;
  a byte on the device gates it, so with tracing off it returns at once).
  On the CPU the same call stamps the host clock below. The spans are
  ``graph`` (row 0: the whole body of a ``core/control.Graph``) and, in
  each stream's row, :data:`STAGE_SPANS`: ``preprocess``,
  ``covariances``, ``s2s``, ``submap``, ``s2m``
  (``odometry/odometry.py``), ``detection``, ``tracker`` and
  ``keyframes`` (``pipeline.py``), and nested in ``detection``,
  :data:`DETECTION_SPANS` (``detection/detection.py``):
  ``detection.project`` (the range and residual images, ground
  removal), ``detection.ccl`` (``label_components``) and
  ``detection.objects`` (``segment_objects``, ``pca_bboxes``, the
  dim-ratio relabel). ``span`` counts the stamps made.
- ``host.<name>.ns`` / ``host.<name>.n``: host spans, :class:`span`
  (:data:`ENTRY_SPANS`: ``entry.prepare``, ``entry.copy_in``,
  ``entry.launch`` and ``entry.clone`` in ``core/control.py`` and the
  entries; ``runner.finalize`` in ``runner.py``). A span also goes into
  a bounded log of (name, start ns, end ns), kept until tracing is next
  switched on; :func:`on_profile` maps it onto a finished
  ``torch.profiler`` session's time base.

The host clock is ``time.time_ns()`` (``CLOCK_REALTIME``, nanoseconds
since the Unix epoch): ``torch.profiler`` stamps its host events with the
same clock (kineto's approximate clock, converted to Unix-epoch ns; an
event's ``time_range`` is microseconds since the session's
``trace_start_ns()``), so a mapped host span and the trace's events
share one time base.
"""

from __future__ import annotations

import collections
import contextlib
import math
import threading
import time
from typing import Any, Dict, Optional

import torch

STAGES = (
    "total",
    "odometry",
    "dynamic",
    "projectScan",
    "projectResiduals",
    "groundRemoval",
    "cloudSegmentation",
    "computeAllObjects",
    "trackDetections",
)


# the device spans of a stream's step, in the order they run (``graph``,
# in row 0, holds them), and the entry's host spans, in the order they run
STAGE_SPANS = ("preprocess", "covariances", "s2s", "submap", "s2m", "detection", "tracker", "keyframes")
DETECTION_SPANS = ("detection.project", "detection.ccl", "detection.objects")  # inside ``detection``
ENTRY_SPANS = ("entry.prepare", "entry.copy_in", "entry.launch", "entry.clone")


def split(counts: Dict[str, int], stream_scans: int) -> Dict[str, Any]:
    """A traced block's counts (:func:`device_counts`) over its
    ``stream_scans``: each stage span's device ms a stream-scan, the
    graph span's ms a replay, the stage spans of one step (all its
    streams) over its graph's span (above 1 where a fleet's branches
    overlap), each entry span's host ms a step (a step: one
    ``entry.launch``) and GICP's lambda trials a stream-scan."""
    steps = counts.get("host.entry.launch.n")
    graph_n = counts.get("span.graph.n")
    stages = {s: counts.get(f"span.{s}.ns", 0) / 1e6 / stream_scans for s in STAGE_SPANS}
    graph = counts["span.graph.ns"] / 1e6 / graph_n if graph_n else None
    return dict(
        stage_device_ms_per_stream_scan=stages,
        graph_device_ms=graph,
        stages_over_graph=sum(stages.values()) * stream_scans / steps / graph if graph and steps else None,
        entry_host_ms_per_step={p: counts.get(f"host.{p}.ns", 0) / 1e6 / steps for p in ENTRY_SPANS}
        if steps else None,
        lm_trials_per_stream_scan=counts.get("lm_trials", 0) / stream_scans,
    )


class Accumulator:
    """last/mean/var/min/max of intervals (accumulator.h:15-52)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self.last = 0.0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf

    def add(self, value_ms: float) -> None:
        self.n += 1
        self.last = value_ms
        d = value_ms - self._mean
        self._mean += d / self.n
        self._m2 += d * (value_ms - self._mean)
        self.min = min(self.min, value_ms)
        self.max = max(self.max, value_ms)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def var(self) -> float:
        return self._m2 / self.n if self.n > 1 else 0.0

    def row(self) -> str:
        if self.n == 0:
            return f"{self.name:>20}:   (no samples)"
        return (
            f"{self.name:>20}: last {self.last:8.3f}  mean {self.mean:8.3f}"
            f"  var {self.var:8.3f}  min {self.min:8.3f}  max {self.max:8.3f}"
        )


class Profiler:
    """Named stage accumulators + dashboard (odom.cc:1387-1458)."""

    def __init__(self, stages=STAGES):
        self.acc: Dict[str, Accumulator] = {s: Accumulator(s) for s in stages}

    def __getitem__(self, name: str) -> Accumulator:
        if name not in self.acc:
            self.acc[name] = Accumulator(name)
        return self.acc[name]

    def dashboard(self) -> str:
        lines = ["DDLO timing [ms]"]
        lines += [a.row() for a in self.acc.values() if a.n > 0]
        return "\n".join(lines)


def device_events(prof) -> list:
    """The device operations of a finished ``torch.profiler`` session:
    its CUDA events but the device side of ``record_function`` ranges
    (user annotations, no device work)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_busy_us(prof) -> tuple:
    """(busy microseconds, kernel count) of a finished ``torch.profiler``
    session: the union of its device operations' intervals
    (:func:`device_events`), so overlapping kernels count once."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in device_events(prof))
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in iv:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, len(iv)


# calls counted on the device: one int64 slot per key (kernel launches by
# the wrappers' names, tracker updates, covariance calls, CCL sweeps, LM
# trials, the spans' sums) in one buffer per device, made outside any
# capture and kept for the process. A captured graph holds the buffer's
# address, so a replay, and every turn of a conditional body, counts as it
# runs. An add is a read-modify-write, not an atomic one: so the buffer
# has a row per branch of a graph (``core/control.branches``, whose
# branches run at once), row 0 outside them, and a read sums the rows.
# Beside it, of the same shape, the open time of each span by its
# ``.ns`` slot, and the byte that gates the device stamps.
MAX_COUNT_KEYS = 96
MAX_COUNT_ROWS = 65
# host spans the log keeps (the oldest dropped first)
MAX_LOG = 1 << 16
_SLOTS: Dict[str, int] = {}
_COUNTS: Dict[str, torch.Tensor] = {}
_OPENED: Dict[str, torch.Tensor] = {}
_GATE: Dict[str, torch.Tensor] = {}
_ROW = threading.local()


class _Tracing:
    """The switch (on while ``depth`` > 0), the host spans' sums by name
    ([ns, n]) and their log."""

    def __init__(self):
        self.depth = 0
        self.on = False
        self.host: Dict[str, list] = {}
        self.log: collections.deque = collections.deque(maxlen=MAX_LOG)


_T = _Tracing()
_SPAN_KERNEL = None  # csrc/trace.cu's ddlo_span, once built


def _key(device: torch.device) -> str:
    return str(device if device.type != "cuda" or device.index is not None
               else torch.device("cuda", torch.cuda.current_device()))


def counts_buffer(device) -> torch.Tensor:
    """The device's count buffer, (rows, keys) (made at its first use,
    which must come before any capture on ``device``, with the open
    times and the gate beside it)."""
    device = torch.device(device)
    key = _key(device)
    if key not in _COUNTS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("profiling: the count buffer is made inside a capture")
        _OPENED[key] = torch.zeros((MAX_COUNT_ROWS, MAX_COUNT_KEYS), dtype=torch.int64,
                                   device=device)
        _GATE[key] = torch.full((1,), int(_T.on), dtype=torch.uint8, device=device)
        _COUNTS[key] = torch.zeros((MAX_COUNT_ROWS, MAX_COUNT_KEYS), dtype=torch.int64,
                                   device=device)
    return _COUNTS[key]


@contextlib.contextmanager
def count_row(row: int):
    """This thread's counts go to ``row`` of the buffer inside the block
    (a graph branch's own row; 0 outside every branch)."""
    if not 0 <= row < MAX_COUNT_ROWS:
        raise ValueError(f"profiling: count row {row} outside 0..{MAX_COUNT_ROWS - 1}")
    prev = getattr(_ROW, "row", 0)
    _ROW.row = row
    try:
        yield
    finally:
        _ROW.row = prev


def _slot(key: str) -> int:
    if key not in _SLOTS:
        if len(_SLOTS) >= MAX_COUNT_KEYS:
            raise RuntimeError(f"profiling: more than {MAX_COUNT_KEYS} count keys")
        _SLOTS[key] = len(_SLOTS)
    return _SLOTS[key]


def count(device, key: str, n: Any = 1) -> None:
    """Add ``n`` (an int, or a 0-d integer tensor on ``device``) to
    ``key``'s count on the device, on the current stream: no host read,
    and inside a capture a node of the graph."""
    counts_buffer(device)[getattr(_ROW, "row", 0), _slot(key)].add_(n)


def count_cell(device, key: str) -> torch.Tensor:
    """``key``'s int64 count in this thread's row, as a 0-d view: for a
    kernel that adds to the count itself (its data pointer), with no
    launch of its own."""
    return counts_buffer(device)[getattr(_ROW, "row", 0), _slot(key)]


def mark(device, end: Optional[str] = None, begin: Optional[str] = None) -> None:
    """A stamp on ``device``'s clock: close the span ``end`` and open the
    span ``begin`` of this thread's count row (either may be None). On
    the card one launch of ``csrc/trace.cu``'s stamp on the current
    stream, whatever the switch (the device's gate decides; inside a
    capture a node of the graph); on the CPU the host clock, while
    tracing is on. A closed span adds its nanoseconds to
    ``span.<end>.ns`` and one to ``span.<end>.n``; a stamp made while
    tracing is on adds one to ``span`` (the stamps' launch count)."""
    global _SPAN_KERNEL
    device = torch.device(device)
    if device.type != "cuda" and not _T.on:
        return
    row = getattr(_ROW, "row", 0)
    e_ns, e_n = (_slot(f"span.{end}.ns"), _slot(f"span.{end}.n")) if end else (-1, -1)
    b = _slot(f"span.{begin}.ns") if begin else -1
    stamp = _slot("span")
    counts = counts_buffer(device)
    opened, gate = _OPENED[_key(device)], _GATE[_key(device)]
    if device.type == "cuda":
        if _SPAN_KERNEL is None:
            from dynamic_direct_lidar_odometry_tpu_torch.ops import nn_cuda

            _SPAN_KERNEL = nn_cuda.build()["trace"].lib.ddlo_span
        with torch.cuda.device(device):
            err = _SPAN_KERNEL(gate.data_ptr(), counts[row].data_ptr(), opened[row].data_ptr(), e_ns, e_n,
                               b, stamp, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"span stamp launch failed: CUDA error {err}")
        return
    t = time.time_ns()
    counts[row, stamp] += 1
    if end and opened[row, e_ns]:
        counts[row, e_ns] += t - opened[row, e_ns]
        counts[row, e_n] += 1
        opened[row, e_ns] = 0
    if begin:
        opened[row, b] = t


class span:
    """``with span("entry.launch"):`` a host span: while tracing is on,
    its nanoseconds on the host clock go to ``host.<name>.ns`` (one call
    to ``host.<name>.n``) and (name, start, end) to the log. Off, it costs
    a test of the switch on entry and on exit. One object may be kept
    and entered again, by one thread at a time."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name
        self.t0 = 0

    def __enter__(self) -> "span":
        self.t0 = time.time_ns() if _T.on else 0
        return self

    def __exit__(self, *exc) -> None:
        if self.t0:
            t1 = time.time_ns()
            h = _T.host.get(self.name)
            if h is None:
                h = _T.host[self.name] = [0, 0]
            h[0] += t1 - self.t0
            h[1] += 1
            _T.log.append((self.name, self.t0, t1))


def _read(buf: torch.Tensor) -> Dict[str, int]:
    """The counts (rows summed) and the host spans' sums, nonzero only."""
    if buf.is_cuda:
        torch.cuda.synchronize(buf.device)
    vals = buf.sum(dim=0).tolist()
    out = {k: vals[i] for k, i in sorted(_SLOTS.items()) if vals[i]}
    for name, (ns, n) in sorted(_T.host.items()):
        out[f"host.{name}.ns"], out[f"host.{name}.n"] = ns, n
    return out


def _zero(device: torch.device) -> None:
    """Counts, open times and host sums to zero (the device's in stream order)."""
    key = _key(device)
    _COUNTS[key].zero_()
    _OPENED[key].zero_()
    _T.host = {}


def interval(device) -> Dict[str, int]:
    """Inside :func:`device_counts`: the counts and span sums since the
    block began or since the last call, zeroed again (the dashboard's
    read of an interval; it waits for the device)."""
    device = torch.device(device)
    out = _read(counts_buffer(device))
    _zero(device)
    return out


@contextlib.contextmanager
def device_counts(device):
    """The counts of :func:`count` and the spans' sums over the block,
    with tracing on: counts, open times and host sums zeroed and the
    device's gate set on entry (in stream order), the host log cleared;
    on exit the gate cleared (after the device's work) and the yielded
    dict filled (``key -> count``, nonzero keys only)."""
    device = torch.device(device)
    buf = counts_buffer(device)
    gate = _GATE[_key(device)]
    _zero(device)
    _T.log.clear()
    gate.fill_(1)
    _T.depth += 1
    _T.on = True
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        vals = _read(buf)
        _T.depth -= 1
        _T.on = _T.depth > 0
        if not _T.on:
            gate.fill_(0)
        out.update(vals)


def host_log() -> list:
    """The host spans logged since tracing was last switched on: (name,
    start ns, end ns) on the host clock."""
    return list(_T.log)


def on_profile(prof, log=None) -> list:
    """``log`` (default: :func:`host_log`) as (name, start us, end us) on
    the time base of the finished ``torch.profiler`` session ``prof``
    (its events' ``time_range``)."""
    res = getattr(prof, "profiler", prof).kineto_results  # torch.profiler.profile wraps the autograd one
    base = res.trace_start_ns()
    return [(n, (a - base) / 1e3, (b - base) / 1e3) for n, a, b in (host_log() if log is None else log)]

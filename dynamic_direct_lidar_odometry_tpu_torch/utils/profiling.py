"""Per-stage wall-clock profiling with the reference's stage taxonomy
(counterpart of ``utils/profiling.py``).

Re-design of ``util/accumulator.h`` (``AccumulatorData``: tick/tock into
accumulators with last/mean/var/min/max, accumulator.h:15-52) and the
console dashboard ``OdomNode::debug`` (odom.cc:1317-1461). Stage names
match the reference so profiles line up:

  total, odometry, dynamic                       (odom.cc:189-192)
  projectScan, projectResiduals, groundRemoval,
  cloudSegmentation, computeAllObjects, trackDetections
                                                 (detection.cpp:64-69)

CUDA work is asynchronous: ``tock`` optionally synchronizes the stream
of a tensor it is given, so the interval covers the device work, and
:func:`annotation` / :func:`trace` label and capture ``torch.profiler``
device timelines. :func:`count` counts calls on the device, so that work
replayed inside a captured graph is counted as it runs, and
:func:`device_counts` reads the counts over a block.
"""

from __future__ import annotations

import contextlib
import math
import os
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


def _block_on(x: Any) -> None:
    """Wait for the device work behind every CUDA tensor in ``x`` (a
    tensor or a nested tuple / list / dict of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.current_stream(x.device).synchronize()
    elif isinstance(x, dict):
        for v in x.values():
            _block_on(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _block_on(v)


class Accumulator:
    """last/mean/var/min/max of tick-tock intervals (accumulator.h:15-52)."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        self.last = 0.0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._t0: Optional[float] = None

    def tick(self) -> None:
        self._t0 = time.perf_counter()

    def tock(self, block_on: Any = None) -> float:
        if block_on is not None:
            _block_on(block_on)
        if self._t0 is None:
            raise RuntimeError(f"tock({self.name}) without tick")
        dt = (time.perf_counter() - self._t0) * 1e3  # ms
        self._t0 = None
        self.add(dt)
        return dt

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

    @contextlib.contextmanager
    def stage(self, name: str, block_on_result: bool = True):
        """``with prof.stage("odometry") as h: h.value = step(...)``: also
        labels the ``torch.profiler`` timeline with the stage."""
        a = self[name]
        with annotation(name):
            a.tick()
            holder = _Holder()
            try:
                yield holder
            finally:
                a.tock(holder.value if block_on_result else None)

    def dashboard(self) -> str:
        lines = ["DDLO timing [ms]"]
        lines += [a.row() for a in self.acc.values() if a.n > 0]
        return "\n".join(lines)


def annotation(name: str):
    """A bare ``torch.profiler`` range label without the wall-clock
    accumulator, for pipelined loops that time dispatch to dispatch."""
    return torch.profiler.record_function(name)


class _Holder:
    """``with prof.stage(..) as h: h.value = out`` to block on device work."""

    value: Any = None


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


@contextlib.contextmanager
def trace(dirname: str):
    """Capture a ``torch.profiler`` host + CUDA trace around a block and
    write it into ``dirname`` as a Chrome trace (``trace.json``)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(dirname, "trace.json"))


# calls counted on the device: one int64 slot per key (kernel launches by
# the wrappers' names, tracker updates, covariance calls, CCL sweeps) in
# one buffer per device, made outside any capture and kept for the
# process. A captured graph holds the buffer's address, so a replay, and
# every turn of a conditional body, counts as it runs. An add is a
# read-modify-write, not an atomic one: so the buffer has a row per
# branch of a graph (``core/control.branches``, whose branches run at
# once), row 0 outside them, and a read sums the rows.
MAX_COUNT_KEYS = 64
MAX_COUNT_ROWS = 65
_SLOTS: Dict[str, int] = {}
_COUNTS: Dict[str, torch.Tensor] = {}
_ROW = threading.local()


def counts_buffer(device) -> torch.Tensor:
    """The device's count buffer, (rows, keys) (made at its first use,
    which must come before any capture on ``device``)."""
    device = torch.device(device)
    key = str(device if device.type != "cuda" or device.index is not None
              else torch.device("cuda", torch.cuda.current_device()))
    if key not in _COUNTS:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("profiling: the count buffer is made inside a capture")
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


def count(device, key: str, n: Any = 1) -> None:
    """Add ``n`` (an int, or a 0-d integer tensor on ``device``) to
    ``key``'s count on the device, on the current stream: no host read,
    and inside a capture a node of the graph."""
    if key not in _SLOTS:
        if len(_SLOTS) >= MAX_COUNT_KEYS:
            raise RuntimeError(f"profiling: more than {MAX_COUNT_KEYS} count keys")
        _SLOTS[key] = len(_SLOTS)
    counts_buffer(device)[getattr(_ROW, "row", 0), _SLOTS[key]].add_(n)


@contextlib.contextmanager
def device_counts(device):
    """The counts of :func:`count` over the block: zeroed on entry (in
    stream order), read on exit into the yielded dict (``key -> count``,
    nonzero keys only)."""
    buf = counts_buffer(device)
    buf.zero_()
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        if buf.is_cuda:
            torch.cuda.synchronize(buf.device)
        vals = buf.sum(dim=0).tolist()
        out.update({k: vals[i] for k, i in sorted(_SLOTS.items()) if vals[i]})

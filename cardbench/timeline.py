"""What a traced stretch of a run shows: the device operations, the host's
CUDA calls, and the per-scan split, reduced from one ``torch.profiler``
session into plain lists that the per-layer metric readers
(``cardbench/metrics/``) read.

The profiler records CUDA activity only: the card's operations and the
host's CUDA runtime calls (``cudaGraphLaunch``, ``cudaMemcpyAsync``, the
synchronizing reads), no per-op host events and no labels, so that what
it costs the host stays small. The stretch runs from the first CUDA call
to the last one's end; each step replays one graph, so a step runs from
its ``cudaGraphLaunch`` to the next.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import stats

LAUNCH = "cudaGraphLaunch"


@dataclasses.dataclass
class TraceView:
    """One traced stretch (times in microseconds on the profiler's clock)."""

    stream_scans: int  # the stretch's stream-scans (steps x streams)
    lo: float  # the stretch's start and end
    hi: float
    device: List[Tuple[float, float, str]]  # device operations (start, end, name)
    host: List[Tuple[float, float, str]]  # host events (start, end, name)
    counts: Dict[str, int]  # the program's device counts over the stretch
    entry_host_ms: List[float]  # host ms of each entry call in the window before the stretch

    @property
    def steps(self) -> List[Tuple[float, float]]:
        """Each step's span: from its graph launch to the next one's (the
        last to the stretch's end)."""
        t = sorted(a for a, _, n in self.host if n == LAUNCH)
        return list(zip(t, t[1:] + [self.hi]))

    def busy_us(self) -> float:
        return stats.busy(stats.clip([(a, b) for a, b, _ in self.device], self.lo, self.hi))

    def device_ops(self) -> int:
        """Device operations that started in the stretch."""
        return sum(1 for a, _, _ in self.device if self.lo <= a <= self.hi)

    def host_calls(self, name: str) -> int:
        return sum(1 for a, _, n in self.host if n == name and self.lo <= a <= self.hi)

    def device_ops_per_step(self) -> List[int]:
        """Device operations that started in each step's span (every step
        ends with a read that waits for its work, so none spills over; a
        step's span holds the next one's copies in)."""
        starts = np.sort(np.array([a for a, _, _ in self.device]))
        return [int(np.searchsorted(starts, b, "left") - np.searchsorted(starts, a, "left"))
                for a, b in self.steps]


def from_profile(prof, stream_scans: int, counts: Dict[str, int],
                 entry_host_ms: List[float]) -> TraceView:
    import torch

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((tr.start, tr.end, e.name))
        else:
            host.append((tr.start, tr.end, e.name))
    spans = host or device
    lo = min((a for a, _, _ in spans), default=0.0)
    hi = max((b for _, b, _ in spans + device), default=0.0)
    return TraceView(stream_scans, lo, hi, device, host, counts, entry_host_ms)


def breakdown(view: TraceView, top: int = 10, attributed: int = 1000, name_chars: int = 120) -> dict:
    """The device operations that took the most time, and the idle time
    by what the host was doing (the innermost host event across each of
    the ``attributed`` longest gaps), each as ``[name, seconds]``; names
    cut to ``name_chars`` (a kernel's template name runs to thousands)."""
    ops = collections.Counter()
    for a, b, name in stats.clip_named(view.device, view.lo, view.hi):
        ops[name[:name_chars]] += (b - a) * 1e-6
    gaps = sorted(stats.gaps([(a, b) for a, b, _ in view.device], view.lo, view.hi),
                  key=lambda g: g[0] - g[1])
    host = view.host
    S = np.array([h[0] for h in host]) if host else np.zeros(0)
    E = np.array([h[1] for h in host]) if host else np.zeros(0)
    idle = collections.Counter()
    for a, b in gaps[:attributed]:
        m = 0.5 * (a + b)
        on = np.nonzero((S <= m) & (E >= m))[0]
        name = host[on[np.argmin(E[on] - S[on])]][2] if len(on) else "host outside CUDA calls"
        idle[name] += (b - a) * 1e-6
    rest = sum(b - a for a, b in gaps[attributed:]) * 1e-6
    if rest:
        idle["shorter gaps"] += rest
    return dict(device_ops=[[n, s] for n, s in ops.most_common(top)],
                idle_gaps=[[n, s] for n, s in idle.most_common(top)])


def summary(view: Optional[TraceView]) -> Optional[dict]:
    """busy_s and window_s of the stretch, for the result's ``device``."""
    if view is None or not view.device or view.hi <= view.lo:
        return None
    return dict(busy_s=view.busy_us() * 1e-6, window_s=(view.hi - view.lo) * 1e-6)

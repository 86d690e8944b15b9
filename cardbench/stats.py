"""The benchmark's arithmetic on timelines: percentiles, rates, the union
of device intervals, idle gaps. Plain Python on lists of numbers, so the
tests can check it on made-up timelines.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values`` by the nearest-rank
    rule: the smallest value with at least q % of the values at or below
    it. A tail is read off the values themselves, never interpolated."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: int, seconds: float) -> float:
    """Work per second over a window."""
    if seconds <= 0:
        raise ValueError("a window of no time")
    return count / seconds


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals (overlapping
    or touching ones merged)."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy(intervals: Iterable[Tuple[float, float]]) -> float:
    """Time covered by at least one interval (``device_busy_us``'s
    union: overlapping operations count once)."""
    return sum(b - a for a, b in merge(intervals))


def clip(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The parts of the intervals inside [lo, hi]."""
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def idle_share(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The share of [lo, hi] in which no interval runs."""
    if hi <= lo:
        raise ValueError("an empty stretch")
    return 1.0 - busy(clip(intervals, lo, hi)) / (hi - lo)


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle gaps of [lo, hi]: the stretches no interval covers."""
    out, t = [], lo
    for a, b in merge(clip(intervals, lo, hi)):
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def clip_named(intervals: Iterable[Tuple[float, float, str]], lo: float,
               hi: float) -> List[Tuple[float, float, str]]:
    """:func:`clip` of named intervals, each keeping its name."""
    return [(max(a, lo), min(b, hi), n) for a, b, n in intervals if b > lo and a < hi]

"""The benchmark's arithmetic on times: a rate over a whole window, a
percentile over every sample, and the union of device intervals."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Work done over the whole window: `count` over `seconds`."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile of every value, interpolated linearly between
    the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals, start: float | None = None,
          end: float | None = None) -> list:
    """The union of (start, end) intervals, clipped to [start, end] where
    given, as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if start is not None:
            a = max(a, start)
        if end is not None:
            b = min(b, end)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def covered(intervals, start: float, end: float) -> float:
    """Length of [start, end] that the intervals cover."""
    return sum(b - a for a, b in union(intervals, start, end))


def gaps(intervals, start: float, end: float) -> list:
    """The stretches of [start, end] that no interval covers."""
    out = []
    at = start
    for a, b in union(intervals, start, end):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if end > at:
        out.append((at, end))
    return out


def idle_pct(intervals, start: float, end: float) -> float:
    """100 x the share of [start, end] that no interval covers."""
    return 100.0 * (1.0 - covered(intervals, start, end) / (end - start))

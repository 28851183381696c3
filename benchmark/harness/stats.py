"""Arithmetic of the end-to-end metrics and of the device trace."""
from __future__ import annotations

import math
import statistics


def rate(count: int, seconds: float) -> float:
    """Work done per second: every unit over all the time."""
    return count / seconds


def percentile_nearest_rank(values, q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: the
    smallest value with at least q% of all values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``'
    quartiles, the exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def subtract(base, cuts):
    """``base`` minus the union of ``cuts`` (both lists of intervals)."""
    cuts = merge(cuts)
    out = []
    for a, b in merge(base):
        cur = a
        for c, d in cuts:
            if d <= cur or c >= b:
                continue
            if c > cur:
                out.append((cur, c))
            cur = max(cur, d)
        if cur < b:
            out.append((cur, b))
    return out


def complement(busy, lo: float, hi: float):
    """The gaps of [lo, hi) not covered by ``busy``."""
    return subtract([(lo, hi)], busy)


def label_segments(ranges):
    """Host timeline segments labelled by the innermost range open over
    them.  ``ranges``: (start, end, label), properly nested or disjoint.
    Returns sorted (start, end, label) with no overlaps; time outside all
    ranges has no segment."""
    events = []
    for k, (a, b, name) in enumerate(ranges):
        if b > a:
            events.append((a, 1, -(b - a), k, name))
            events.append((b, 0, 0, k, name))
    events.sort()
    stack, out, last = [], [], None
    for t, kind, _, k, name in events:
        if stack and last is not None and t > last:
            out.append((last, t, stack[-1][1]))
        if kind == 1:
            stack.append((k, name))
        else:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][0] == k:
                    del stack[i]
                    break
        last = t
    return out


def attribute(intervals, segments, outside: str):
    """Seconds of ``intervals`` under each segment's label (time under no
    segment goes to ``outside``)."""
    totals: dict = {}
    segs = sorted(segments)
    for a, b in merge(intervals):
        covered = 0.0
        for s, e, name in segs:
            if e <= a:
                continue
            if s >= b:
                break
            d = min(b, e) - max(a, s)
            if d > 0:
                totals[name] = totals.get(name, 0.0) + d
                covered += d
        if b - a - covered > 0:
            totals[outside] = totals.get(outside, 0.0) + (b - a - covered)
    return totals

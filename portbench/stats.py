"""The benchmark's arithmetic: rates, tails, unions of intervals, spreads.

Kept apart from the program, so that no change to the program moves how a
number is worked out.
"""
import math
import statistics


def rate(units, seconds):
    """All the work of the window over all of its seconds."""
    if seconds <= 0:
        raise ValueError("a window of %r seconds" % seconds)
    return units / seconds


def tail(values, q=0.95):
    """The nearest-rank ``q`` quantile of every value; ``math.inf`` stands
    for a request that never completed and ranks above every other."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def union_seconds(intervals, lo=-math.inf, hi=math.inf):
    """The length of the union of ``(start, end)`` intervals, each clipped
    to ``[lo, hi]``: overlapping work counts once."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle stretches of ``[lo, hi]`` that no interval covers, as
    ``(start, end)``, longest first."""
    out = []
    at = lo
    for s, e in sorted(intervals):
        if e <= at:
            continue
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    out = [(s, e) for s, e in out if e > s]
    return sorted(out, key=lambda g: g[0] - g[1])


def spread(values):
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

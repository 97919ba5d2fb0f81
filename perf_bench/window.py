"""The arithmetic of a measured window.

A rate is all the work completed in the window over the window's own
length; the window ends at the first work boundary after the run's seconds.
A tail is taken over every step of the window. Nothing is a median of
chunks.
"""

import math
import random


def rate(work, seconds):
    """Work per second over a window of `seconds`."""
    if seconds <= 0:
        raise ValueError("a window must have a length")
    return work / seconds


def percentile(values, q):
    """The q-th percentile (0 < q <= 100) of `values` by nearest rank: the
    smallest value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def median(values):
    ordered = sorted(values)
    n = len(ordered)
    return (ordered[(n - 1) // 2] + ordered[n // 2]) / 2.0


def intervals_between(stamps):
    """The lengths between consecutive time stamps."""
    return [b - a for a, b in zip(stamps, stamps[1:])]


def merged_length(intervals):
    """Total length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def gaps(intervals, start, end):
    """The (start, end) stretches of [start, end] that no interval
    covers."""
    out, reach = [], start
    for a, b in sorted(intervals):
        if a > reach:
            out.append((reach, min(a, end)))
        reach = max(reach, b)
        if reach >= end:
            break
    if reach < end:
        out.append((reach, end))
    return [(a, b) for a, b in out if b > a]


class Reservoir:
    """A uniform sample of k of the steps offered, drawn from a seeded
    generator (Algorithm R): `offer(i)` says whether step i is kept and
    which kept step, if any, it displaces."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = random.Random(seed)
        self.kept = []
        self.seen = 0

    def offer(self, step):
        """(keep, dropped step or None)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(step)
            return True, None
        j = self.rng.randrange(self.seen)
        if j >= self.k:
            return False, None
        dropped, self.kept[j] = self.kept[j], step
        return True, dropped

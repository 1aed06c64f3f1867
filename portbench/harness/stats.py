"""The benchmark's arithmetic: window rates, percentiles over all requests,
the union of device intervals, roofline shares and run-to-run spreads."""

import math
import statistics
from typing import Iterable, Sequence, Tuple


def window_rate(units: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    if seconds <= 0:
        raise ValueError(f"window of {seconds} s")
    return units / seconds


def percentile(values: Sequence[float], pct: float) -> float:
    """The pct-th percentile of every value, linear between the closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, -math.inf
    for s, t in sorted(intervals):
        total += max(0.0, t - max(s, end))
        end = max(end, t)
    return total


def idle_share(busy_s: float, wall_s: float) -> float:
    """1 - busy / wall, in percent."""
    return 100.0 * (1.0 - busy_s / wall_s)


def roofline_pct(flops: float, nbytes: float, device_s: float, peak_flops: float,
                 peak_bytes_per_s: float):
    """The least time the card could take (the larger of operations over
    peak and bytes over bandwidth) over the time taken, in percent; None
    where nothing was timed."""
    if not device_s > 0:
        return None
    return 100.0 * max(flops / peak_flops, nbytes / peak_bytes_per_s) / device_s


def spread(values: Sequence[float]) -> float:
    """Interquartile distance over the median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med

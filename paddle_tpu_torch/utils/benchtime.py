"""Robust per-call time estimation from chained segments (the port's copy
of ``paddle_tpu/utils/benchtime.py``: pure functions, unchanged).

Where each timed segment carries a fixed-plus-jitter overhead of its own
(one host synchronisation, a launch queue to drain), per-call time is
estimated by differencing two chained segments of different lengths, which
cancels the fixed part. The differencing means something only when the
added work between the segments is large against the jitter: a tiny
positive delta would read as an impossible bandwidth. These helpers make
the estimate robust (median of repeats, jitter-aware sizing) and are pure
functions, so tests feed them synthetic noisy timings.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple


def median_differenced_estimate(times_short: List[float],
                                times_long: List[float],
                                k_short: int, k_long: int,
                                fallback: Optional[float] = None) -> float:
    """Median of per-pair differenced per-call estimates.

    times_short[i]/times_long[i] are wall times of chained segments of
    k_short/k_long calls (same fixed sync overhead in each). Pairs with a
    non-positive delta (jitter exceeded signal) are dropped; if all pairs are
    dropped, returns `fallback` (an overhead-inclusive per-call time -- an
    overestimate, hence a *conservative* bandwidth).
    """
    if k_long <= k_short:
        raise ValueError(f"k_long ({k_long}) must exceed k_short ({k_short})")
    deltas = [(tl - ts) / (k_long - k_short)
              for ts, tl in zip(times_short, times_long) if tl - ts > 0]
    if not deltas:
        if fallback is None:
            raise ValueError("all differenced estimates non-positive and no "
                             "fallback given")
        return fallback
    deltas.sort()
    return deltas[len(deltas) // 2]


def sized_per_call(segment: Callable[[int], float], k_probe: int = 20,
                   repeats: int = 3,
                   max_calls: int = 20000) -> Tuple[float, float]:
    """(per_call, per_call_conservative) for a chained-segment benchmark.

    segment(k) runs k chained calls and returns wall time including one sync.
    The probe time is overhead-dominated when per-call work is small, so
    sizing from it alone under-sizes the chain: instead, double
    the chain length until a segment takes >= 3x the probe time -- at that
    point chained *work* is at least ~2x the sync overhead (seconds-scale
    against the sync jitter) regardless of how the probe split between
    work and overhead. The differenced estimate is the median of `repeats`
    short/long pairs; the conservative value (overhead-inclusive, can only
    understate bandwidth) is the fallback when differencing fails or the
    result trips a physical-sanity clamp.
    """
    t_probe = segment(k_probe)
    k_short = k_probe
    t = t_probe
    while t < 3 * t_probe and k_short < max_calls // 5:
        k_short = min(2 * k_short, max_calls // 5)
        t = segment(k_short)
    k_long = 5 * k_short
    times_short = [segment(k_short) for _ in range(repeats)]
    times_long = [segment(k_long) for _ in range(repeats)]
    # conservative bound from the LONG segments (work-dominated), not the
    # probe (overhead-dominated -- up to 100x loose): still overhead-
    # inclusive, so it can only overstate per-call time / understate
    # bandwidth, but now by O(overhead / k_long work), not O(overhead/probe).
    per_call_ub = min(times_long) / k_long
    per_call = median_differenced_estimate(times_short, times_long, k_short,
                                           k_long, fallback=per_call_ub)
    return per_call, per_call_ub

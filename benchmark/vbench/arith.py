"""The benchmark's arithmetic: the peaks, the k-NN pair's work, the union of
device intervals and its gaps, the percentile and the spread.

``PEAK_F32``, ``PEAK_BW``, ``KNN_PAIR_OPS`` and ``knn_work`` are copied from
``chip_smoke.py`` at commit 2b93434 (there: the kernel table's bounds), so
later edits to the program cannot move the yardstick.
"""

from __future__ import annotations

import statistics
from collections import defaultdict

# published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32 = 67e12       # FLOP/s
PEAK_BW = 3.35e12      # bytes/s
KNN_PAIR_OPS = 9       # per (live query, live candidate): 3 sub, 3 mul, 2 add, 1 compare


def knn_work(m: int, n: int, k: int, live_q: int, live_c: int) -> tuple[int, int]:
    """(operations, bytes) of one k-NN problem of m queries, n candidates
    and k neighbours with ``live_q`` live queries and ``live_c`` live
    candidates: KNN_PAIR_OPS per (live query, live candidate) pair; queries,
    candidates and mask read once, (d2 f32, idx int64) written once
    (chip_smoke.knn_work, with the counts already read)."""
    return KNN_PAIR_OPS * live_q * live_c, 12 * (m + n) + n + 12 * m * k


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / PEAK_F32, nbytes / PEAK_BW)


def merged(intervals) -> list:
    """Sorted, disjoint (start, end) covering the union of ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_length(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def gaps(intervals, start, end) -> list:
    """The (start, end) stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in merged(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def sum_by_name(ops) -> list:
    """[(name, summed duration), ...] of (name, start, end), longest first."""
    tot = defaultdict(float)
    for name, s, e in ops:
        tot[name] += e - s
    return sorted(tot.items(), key=lambda kv: -kv[1])


def p95(values) -> float:
    """The 95th percentile (``statistics.quantiles``, exclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


def spread(values) -> float:
    """Interquartile distance as a share of the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2

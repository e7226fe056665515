"""Percentiles, copied from the program's ``repro_torch/obs/metrics.py``
(``percentile_interp``) so that the yardstick cannot move with it."""

from __future__ import annotations

import math


def percentile_interp(ordered, p: float) -> float:
    """Linear-interpolated percentile of a sorted sequence: ``rank = (n - 1)
    * p / 100`` between the two neighbouring order statistics (numpy's
    ``method="linear"``); empty gives 0.0, one sample that sample."""
    vals = list(ordered)
    n = len(vals)
    if n == 0:
        return 0.0
    if n == 1 or p <= 0.0:
        return float(vals[0])
    if p >= 100.0:
        return float(vals[-1])
    rank = (n - 1) * (p / 100.0)
    lo = int(math.floor(rank))
    hi = min(lo + 1, n - 1)
    frac = rank - lo
    a, b = float(vals[lo]), float(vals[hi])
    if frac == 0.0 or a == b:
        return a
    return a + (b - a) * frac

"""Order statistics of the window's timings."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]

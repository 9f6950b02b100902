"""Order statistics of a window's samples."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks of the sorted samples (numpy's default)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def beyond(values: Sequence[float], q: float) -> int:
    """How many samples lie above the ``q``-th percentile."""
    p = percentile(values, q)
    return sum(1 for v in values if v > p)

"""The window's arithmetic: nearest-rank percentiles and rates."""
from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``q``
    percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[rank - 1]


def rate(count: float, seconds: float) -> float:
    """``count`` per second of a window ``seconds`` long."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds

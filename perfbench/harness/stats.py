"""Statistics the harness reports: percentiles over every request, rates
over whole units of work, and the spread that sets a bound."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every value, a
    missing one (a failed request) counted as ``inf``: the value that at
    least ``q`` percent of the values do not exceed."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def rate(units: float, seconds: float) -> float:
    """Work a second: every unit completed over the whole time it took."""
    if seconds <= 0:
        raise ValueError(f"rate over {seconds} s")
    return units / seconds


def spread(values) -> float:
    """Distance between the first and third quartile (Python's
    ``statistics.quantiles(n=4)``) as a share of the median."""
    q1, median, q3 = statistics.quantiles(list(values), n=4)
    return (q3 - q1) / median

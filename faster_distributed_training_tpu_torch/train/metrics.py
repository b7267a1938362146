"""Metric helpers (``percentiles`` so far), copied from the JAX
package's ``train/metrics.py``."""

from __future__ import annotations

import math
from typing import Dict, Iterable


def percentiles(values: Iterable[float],
                qs: Iterable[int] = (50, 95, 99)) -> Dict[int, float]:
    """Nearest-rank percentiles of host floats — {q: value}, {} when
    empty.  Nearest-rank, not interpolated: a reported p99 is a value
    that actually happened."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return {}
    out = {}
    for q in qs:
        idx = max(0, min(len(vals) - 1,
                         math.ceil(q / 100.0 * len(vals)) - 1))
        out[int(q)] = round(vals[idx], 3)
    return out

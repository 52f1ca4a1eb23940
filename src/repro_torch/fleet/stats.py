"""Bounded streaming quantile windows for per-pair serving telemetry.

:class:`RollingQuantile` keeps the last ``size`` samples in a ring plus a
parallel sorted list — O(log n) lookup, O(n) insert/evict on a
few-hundred-entry window, and strictly bounded memory (no unbounded
per-request lists). It backs ``pair_summaries()``'s rolling p50/p95
TTFT/TPOT columns and the SLO-aware admission path (a pair whose rolling
p95 TTFT drifts past a request class's SLO stops admitting that class).
"""

from __future__ import annotations

import bisect
import math
from collections import deque


class RollingQuantile:
    """Sorted-window quantile estimator over the most recent ``size``
    samples (arrival order evicts)."""

    def __init__(self, size: int = 256):
        assert size >= 1, "window size must be >= 1"
        self.size = int(size)
        self._ring: deque[float] = deque()
        self._sorted: list[float] = []

    def push(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        if len(self._ring) >= self.size:
            old = self._ring.popleft()
            i = bisect.bisect_left(self._sorted, old)
            del self._sorted[i]
        self._ring.append(v)
        bisect.insort(self._sorted, v)

    def quantile(self, p: float) -> float:
        """Linear-interpolated quantile of the current window; NaN when
        empty (same convention as the sim analyzer's ``_percentile``)."""
        s = self._sorted
        if not s:
            return math.nan
        k = (len(s) - 1) * min(1.0, max(0.0, p))
        lo, hi = int(math.floor(k)), int(math.ceil(k))
        if lo == hi:
            return s[lo]
        return s[lo] + (s[hi] - s[lo]) * (k - lo)

    def p50(self) -> float:
        return self.quantile(0.5)

    def p95(self) -> float:
        return self.quantile(0.95)

    def mean(self) -> float:
        return sum(self._ring) / len(self._ring) if self._ring else math.nan

    def __len__(self) -> int:
        return len(self._ring)

    def __repr__(self) -> str:
        return (f"RollingQuantile(n={len(self._ring)}, "
                f"p50={self.p50():.2f}, p95={self.p95():.2f})")

"""Runtime stat registry — the port's copy of the part of
``paddle_tpu/core/monitor.py`` the serving engine uses: named counters
(``stat_add``/``stat_set``/``get_stat``) and fixed-bucket latency
histograms (``observe``/``get_histogram``), thread-safe, in one global
registry."""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any

__all__ = ["StatRegistry", "stats", "stat_add", "stat_set", "get_stat",
           "observe", "get_histogram"]

# Fixed log-spaced histogram buckets: 3 per decade from 1e-7 to 1e+3 plus
# one overflow bucket (``paddle_tpu/core/monitor.py:34-37``).
_BUCKET_BOUNDS = tuple(10.0 ** (-7 + i / 3.0) for i in range(31))


class _Histogram:
    """Fixed-bucket histogram; quantiles by log interpolation inside the
    landing bucket, clamped to the observed min and max. Mutated only
    under the owning registry's lock."""

    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self):
        self.counts = [0] * (len(_BUCKET_BOUNDS) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(_BUCKET_BOUNDS, value)] += 1
        self.sum += value
        self.count += 1
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def quantile(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c:
                lo = _BUCKET_BOUNDS[i - 1] if i > 0 else self.min
                hi = (_BUCKET_BOUNDS[i] if i < len(_BUCKET_BOUNDS)
                      else self.max)
                lo, hi = max(lo, self.min), min(hi, self.max)
                if lo <= 0 or hi <= lo:
                    return hi
                return lo * (hi / lo) ** ((target - (cum - c)) / c)
        return self.max

    def summary(self) -> dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class StatRegistry:
    """Thread-safe named counters and observation histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats: dict[str, float] = {}
        self._hists: dict[str, _Histogram] = {}

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._stats[name] = value

    def get(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._stats.get(name, default)

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = _Histogram()
            h.observe(float(value))

    def histogram(self, name: str) -> dict[str, float] | None:
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else None


stats = StatRegistry()          # the global registry


def stat_add(name: str, value: float = 1) -> None:
    stats.add(name, value)


def stat_set(name: str, value: float) -> None:
    stats.set(name, value)


def get_stat(name: str, default: float = 0) -> float:
    return stats.get(name, default)


def observe(name: str, value: float) -> None:
    """Record a histogram observation in the global registry."""
    stats.observe(name, value)


def get_histogram(name: str) -> dict[str, float] | None:
    return stats.histogram(name)

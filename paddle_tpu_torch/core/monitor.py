"""Runtime stat registry — the port's copy of the part of
``paddle_tpu/core/monitor.py`` the serving stack uses: named counters
(``stat_add``/``stat_set``/``get_stat``) and fixed-bucket latency
histograms (``observe``/``get_histogram``), thread-safe, in one global
registry; their snapshots with a name-prefix filter
(``export_stats``/``export_histograms``, raw bucket counts for merging
across processes: ``merge_histograms``), the SLO-violation share of a raw
histogram (``hist_fraction_above``) and ``reset_stats``."""

from __future__ import annotations

import bisect
import math
import threading
from typing import Any

__all__ = ["StatRegistry", "stats", "stat_add", "stat_set", "get_stat",
           "observe", "get_histogram", "export_stats", "export_histograms",
           "merge_histograms", "hist_fraction_above", "reset_stats"]

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

    def summary(self, raw: bool = False) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(0.50), "p95": self.quantile(0.95),
            "p99": self.quantile(0.99)}
        if raw:
            # bucket counts, so that histograms of different processes
            # merge (fixed bounds make counts addable)
            doc["buckets"] = list(self.counts)
        return doc

    @classmethod
    def from_raw(cls, doc: dict[str, Any]) -> "_Histogram":
        h = cls()
        buckets = list(doc.get("buckets") or ())
        if len(buckets) == len(h.counts):
            h.counts = [int(c) for c in buckets]
        h.sum = float(doc.get("sum", 0.0))
        h.count = int(doc.get("count", 0))
        if h.count:
            h.min = float(doc.get("min", 0.0))
            h.max = float(doc.get("max", 0.0))
        return h

    def merge(self, other: "_Histogram") -> None:
        self.counts = [a + b for a, b in zip(self.counts, other.counts)]
        self.sum += other.sum
        self.count += other.count
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)


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

    def export(self, prefix: str | None = None) -> dict[str, float]:
        with self._lock:
            return {k: v for k, v in self._stats.items()
                    if prefix is None or k.startswith(prefix)}

    def export_histograms(self, prefix: str | None = None,
                          raw: bool = False) -> dict[str, dict[str, Any]]:
        with self._lock:
            return {k: h.summary(raw) for k, h in self._hists.items()
                    if prefix is None or k.startswith(prefix)}

    def reset(self, prefix: str | None = None) -> None:
        with self._lock:
            for table in (self._stats, self._hists):
                for k in [k for k in table
                          if prefix is None or k.startswith(prefix)]:
                    del table[k]


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


def export_stats(prefix: str | None = None) -> dict[str, float]:
    """The counters whose names start with ``prefix`` (all: None)."""
    return stats.export(prefix)


def export_histograms(prefix: str | None = None, raw: bool = False
                      ) -> dict[str, dict[str, Any]]:
    """Histogram summaries whose names start with ``prefix``; ``raw`` adds
    each one's bucket counts for :func:`merge_histograms` (what the wire
    ``health`` op ships to fleet scrapers)."""
    return stats.export_histograms(prefix, raw)


def merge_histograms(docs: list[dict[str, Any]],
                     raw: bool = False) -> dict[str, Any]:
    """Raw histogram snapshots (``export_histograms(raw=True)`` entries,
    one per endpoint) merged into one summary with exact combined
    quantiles: every process shares the bucket bounds."""
    merged = _Histogram()
    for doc in docs:
        merged.merge(_Histogram.from_raw(doc))
    return merged.summary(raw)


def hist_fraction_above(doc: dict[str, Any], threshold: float,
                        conservative: bool = False) -> float:
    """Share of a raw histogram snapshot's observations at or above
    ``threshold`` (the SLO-violation numerator of a burn rate). Buckets
    above the threshold's count in full; the bucket the threshold lands
    in contributes the linearly interpolated share of its mass above it
    (``conservative=True``: none of it). 0.0 for an empty snapshot or one
    without buckets."""
    buckets = doc.get("buckets") if doc else None
    total = int(doc.get("count", 0)) if doc else 0
    if not buckets or total <= 0:
        return 0.0
    # bucket j holds (bounds[j-1], bounds[j]]; every bucket past j is above
    j = bisect.bisect_left(_BUCKET_BOUNDS, threshold)
    above = float(sum(int(c) for c in buckets[j + 1:]))
    boundary = int(buckets[j]) if j < len(buckets) else 0
    if boundary and not conservative:
        lo = _BUCKET_BOUNDS[j - 1] if j > 0 else 0.0
        # the overflow bucket's upper bound is the observed max
        hi = (_BUCKET_BOUNDS[j] if j < len(_BUCKET_BOUNDS)
              else float(doc.get("max", lo)))
        if hi > lo:
            above += boundary * min(max((hi - threshold) / (hi - lo), 0.0),
                                    1.0)
    return min(above / total, 1.0)


def reset_stats(prefix: str | None = None) -> None:
    """Drop the counters and histograms whose names start with ``prefix``
    (all: None)."""
    stats.reset(prefix)

"""Streaming latency / stall-duration histograms for tail-latency SLOs.

``LatencyHistogram`` is a log-bucketed (HDR-style) streaming histogram:
bucket edges grow geometrically by ``gamma`` (default ``2**(1/8)``, i.e.
8 buckets per doubling), so any quantile estimate ``est`` of a true value
``v`` satisfies ``v <= est <= v * gamma`` -- a bounded ~9% relative error
at any scale, from sub-microsecond stalls to multi-second pauses, with
O(log(range)) memory and O(1) record cost. Counts are exact integers, so
histograms **merge exactly** (merge is associative and commutative --
per-shard or per-window histograms aggregate without error accumulation),
and ``delta(prev)`` recovers a measurement window from two snapshots the
same way ``IOStats.delta`` does.

The exact min and max are tracked on the side: ``max_value`` (the
max-stall column) is exact, and quantile estimates clamp into
``[min, max]`` so a one-sample histogram reports that sample exactly.

A serving system is judged on its tail: ``StorageService`` records every
``submit()`` into one of these (plus a second histogram of maintenance
stall durations), and ``benchmarks/`` emits ``p99_us`` / ``p999_us`` /
``max_stall_us`` columns from window deltas next to throughput.
"""
from __future__ import annotations

import math


class LatencyHistogram:
    """Log-bucketed streaming histogram with exact mergeable counts."""

    def __init__(self, *, gamma: float = 2.0 ** 0.125, v0: float = 1e-3):
        if gamma <= 1.0:
            raise ValueError(f"gamma must be > 1, got {gamma}")
        if v0 <= 0.0:
            raise ValueError(f"v0 must be > 0, got {v0}")
        self.gamma = float(gamma)
        self.v0 = float(v0)          # upper edge of bucket 0
        self._lg = math.log(self.gamma)
        self._counts: dict[int, int] = {}
        self.count = 0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -------------------------------------------------------------
    def _bucket(self, value: float) -> int:
        """Index of the bucket whose range ``(v0*g^(i-1), v0*g^i]``
        contains ``value``; everything at or below ``v0`` lands in 0."""
        if value <= self.v0:
            return 0
        return max(0, math.ceil(math.log(value / self.v0) / self._lg))

    def record(self, value: float, n: int = 1) -> None:
        """Record ``n`` observations of ``value`` (must be >= 0)."""
        if value < 0:
            raise ValueError(f"latency values must be >= 0, got {value}")
        if n <= 0:
            return
        i = self._bucket(value)
        self._counts[i] = self._counts.get(i, 0) + n
        self.count += n
        if value < self._min:
            self._min = value
        if value > self._max:
            self._max = value

    # -- quantiles -------------------------------------------------------------
    def quantile(self, q: float) -> float:
        """Estimate of the ``q``-quantile (0 <= q <= 1); 0.0 when empty.
        The estimate is a bucket's upper edge clamped into the exact
        ``[min, max]``, so ``true <= estimate <= true * gamma``."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i in sorted(self._counts):
            seen += self._counts[i]
            if seen >= rank:
                edge = self.v0 * self.gamma ** i
                return min(max(edge, self._min), self._max)
        return self._max                              # pragma: no cover

    @property
    def p50(self) -> float:
        return self.quantile(0.50)

    @property
    def p99(self) -> float:
        return self.quantile(0.99)

    @property
    def p999(self) -> float:
        return self.quantile(0.999)

    @property
    def min_value(self) -> float:
        """Exact minimum recorded value (0.0 when empty)."""
        return self._min if self.count else 0.0

    @property
    def max_value(self) -> float:
        """Exact maximum recorded value (0.0 when empty)."""
        return self._max if self.count else 0.0

    def summary(self) -> dict:
        """The standard BENCH/governor view of this histogram: exact
        count/min/max plus the bounded-error quantile ladder."""
        return {"count": self.count, "p50": self.p50, "p99": self.p99,
                "p999": self.p999, "min": self.min_value,
                "max": self.max_value}

    # -- composition -----------------------------------------------------------
    def _compatible(self, other: "LatencyHistogram") -> None:
        if (self.gamma, self.v0) != (other.gamma, other.v0):
            raise ValueError(
                f"histogram geometry mismatch: (gamma={self.gamma}, "
                f"v0={self.v0}) vs (gamma={other.gamma}, v0={other.v0})")

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Exact combination of two histograms (new object; associative
        and commutative -- per-shard histograms aggregate without error)."""
        self._compatible(other)
        out = LatencyHistogram(gamma=self.gamma, v0=self.v0)
        for h in (self, other):
            for i, c in h._counts.items():
                out._counts[i] = out._counts.get(i, 0) + c
        out.count = self.count + other.count
        out._min = min(self._min, other._min)
        out._max = max(self._max, other._max)
        return out

    def copy(self) -> "LatencyHistogram":
        out = LatencyHistogram(gamma=self.gamma, v0=self.v0)
        out._counts = dict(self._counts)
        out.count = self.count
        out._min = self._min
        out._max = self._max
        return out

    def delta(self, prev: "LatencyHistogram") -> "LatencyHistogram":
        """The window between snapshot ``prev`` and now (``prev`` must be
        an earlier ``copy()`` of this histogram). Counts subtract exactly;
        the window max is exact when the window grew it, else the highest
        nonzero delta bucket's upper edge (within the gamma bound)."""
        self._compatible(prev)
        out = LatencyHistogram(gamma=self.gamma, v0=self.v0)
        for i, c in self._counts.items():
            d = c - prev._counts.get(i, 0)
            if d < 0:
                raise ValueError(
                    "delta(prev): prev is not an earlier snapshot "
                    f"(bucket {i} shrank {prev._counts.get(i, 0)} -> {c})")
            if d:
                out._counts[i] = d
        out.count = self.count - prev.count
        if out.count:
            buckets = sorted(out._counts)
            # window extrema: exact when the window moved the global
            # extremum, else bucket-edge bounds (<= gamma error)
            out._max = self._max if self._max > prev._max \
                else self.v0 * self.gamma ** buckets[-1]
            out._min = self._min if self._min < prev._min \
                else self.v0 * self.gamma ** max(0, buckets[0] - 1)
        return out

"""Bounded-memory latency metrics (the part of ``repro.obs.metrics`` the
port uses).

  * :class:`Histogram` — geometric fixed-bucket value distribution:
    ~5% relative bucket width over [1e-4, 1e7], constant memory.
  * :class:`LatencyRecorder` — a ring of the newest ``cap`` raw samples
    (exact percentiles while it has seen at most ``cap`` values) feeding
    a Histogram that answers percentiles past that.
  * :class:`CounterSet` — a named family of monotone counters, read
    like a dict (``serve.telemetry.StreamTelemetry`` keeps one).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Dict

import numpy as np

__all__ = ["CounterSet", "Histogram", "LatencyRecorder"]


class CounterSet:
    """Named monotone counters, insertion-ordered, read like a dict
    (``counters["capacity_bumps"]``)."""

    def __init__(self, names=()):
        self._c: Dict[str, int] = {str(n): 0 for n in names}

    def bump(self, name: str, n: int = 1) -> None:
        self._c[name] = self._c.get(name, 0) + int(n)

    def as_dict(self) -> Dict[str, int]:
        return dict(self._c)

    def __getitem__(self, name: str) -> int:
        return self._c[name]


class Histogram:
    """Geometric fixed-bucket histogram: constant memory at any count."""

    def __init__(self, lo: float = 1e-4, hi: float = 1e7,
                 growth: float = 1.1):
        if not (lo > 0 and hi > lo and growth > 1):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self._log_growth = math.log(growth)
        self._n_buckets = int(math.ceil(
            math.log(hi / lo) / self._log_growth))
        # [underflow] + n regular + [overflow]
        self._counts = np.zeros(self._n_buckets + 2, np.int64)
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def _index(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n_buckets + 1
        return 1 + int(math.log(v / self.lo) / self._log_growth)

    def _edge(self, i: int) -> float:
        return self.lo * math.exp(i * self._log_growth)

    def record(self, v: float) -> None:
        v = float(v)
        self._counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else float("nan")

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile: find the bucket holding the rank,
        interpolate geometrically inside it, clamp to [min, max]."""
        if self.count == 0:
            return float("nan")
        rank = (q / 100.0) * (self.count - 1)
        cum = np.cumsum(self._counts)
        b = int(np.searchsorted(cum, rank, side="right"))
        b = min(b, self._counts.size - 1)
        if b == 0:
            est = min(self.lo, self.max)
        elif b == self._counts.size - 1:
            est = self.max
        else:
            lo_edge = self._edge(b - 1)
            hi_edge = self._edge(b)
            prev = float(cum[b - 1])
            inside = float(self._counts[b])
            frac = ((rank - prev) / inside) if inside > 0 else 0.0
            est = lo_edge * (hi_edge / lo_edge) ** frac
        return float(min(max(est, self.min), self.max))


class LatencyRecorder:
    """Per-request latencies (milliseconds) in bounded memory."""

    def __init__(self, cap: int = 4096):
        if cap < 2:
            raise ValueError("cap must be >= 2")
        self.cap = int(cap)
        self._ring = deque(maxlen=self.cap)
        self._hist = Histogram()

    def record(self, ms: float) -> None:
        ms = float(ms)
        self._ring.append(ms)
        self._hist.record(ms)

    @property
    def count(self) -> int:
        return self._hist.count

    @property
    def mean(self) -> float:
        return self._hist.mean

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        if self.count <= self.cap:        # ring holds every sample: exact
            return float(np.percentile(np.asarray(self._ring), q))
        return self._hist.percentile(q)

    def summary(self) -> dict:
        return {"requests": self.count,
                "p50_ms": round(self.percentile(50), 3),
                "p99_ms": round(self.percentile(99), 3)}


"""The one monotonic clock every latency number in the port reads
(a copy of ``repro.obs.clock``).

Host-side timing goes through :func:`now` so every timestamp is
comparable. A host clock around device work measures the enqueue unless
the caller synchronizes first; the serving session synchronizes before
it reads the clock.
"""
from __future__ import annotations

import time

__all__ = ["now", "wall", "ms_between"]

# bound at import: one attribute lookup per call, and monkeypatching
# time.perf_counter later cannot split the port across two clocks
_perf = time.perf_counter
_wall = time.time


def now() -> float:
    """Monotonic seconds (high resolution); the port-wide timestamp."""
    return _perf()


def wall() -> float:
    """Wall-clock epoch seconds, only for anchoring traces to calendar
    time; never for measuring durations."""
    return _wall()


def ms_between(t0: float, t1: float) -> float:
    """Milliseconds between two :func:`now` readings."""
    return (t1 - t0) * 1e3

"""repro_torch.obs — the port's clock, spans and latency metrics.

Copies of the parts of ``repro.obs`` the serving slice uses:
:mod:`.clock` (the one monotonic clock), :mod:`.trace` (spans via
``get_tracer().span``) and :mod:`.metrics` (bounded ``LatencyRecorder``,
and ``CounterSet``).
"""
from .clock import ms_between, now, wall
from .metrics import CounterSet, Histogram, LatencyRecorder
from .trace import (NULL_SPAN, Span, Tracer, configure, get_tracer,
                    set_tracer)

__all__ = ["now", "wall", "ms_between", "CounterSet", "Histogram",
           "LatencyRecorder", "Span", "Tracer", "NULL_SPAN", "get_tracer",
           "set_tracer", "configure"]

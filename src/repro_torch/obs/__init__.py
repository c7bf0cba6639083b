"""repro_torch.obs — the port's clock, spans, latency metrics and trace
export.

Copies of the parts of ``repro.obs`` the port uses: :mod:`.clock` (the
one monotonic clock), :mod:`.trace` (spans via ``get_tracer().span``,
with a ``torch.profiler.record_function`` bridge under
``device_annotations``), :mod:`.metrics` (bounded ``LatencyRecorder``,
and ``CounterSet``), :mod:`.export` (schema-versioned JSONL) and
:mod:`.report` (the tree/rollup renderer behind
``python -m repro_torch.launch.obs_report``).
"""
from .clock import ms_between, now, wall
from .export import SCHEMA_VERSION, export_jsonl, span_to_dict
from .metrics import CounterSet, Histogram, LatencyRecorder
from .trace import (NULL_SPAN, Span, Tracer, configure, get_tracer,
                    set_tracer)

__all__ = ["now", "wall", "ms_between", "CounterSet", "Histogram",
           "LatencyRecorder", "Span", "Tracer", "NULL_SPAN", "get_tracer",
           "set_tracer", "configure", "SCHEMA_VERSION", "export_jsonl",
           "span_to_dict"]

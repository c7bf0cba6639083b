"""Schema-versioned JSONL trace export (a copy of ``repro.obs.export``:
the same spans give the same lines, apart from the header's clock
anchors).

File layout — one JSON object per line:

  {"kind": "header", "schema": 1, "wall_t0": ..., "perf_t0": ...,
   "dropped": N, "n_spans": N}
  {"kind": "span", "trace": "t000001", "span": "s000001", "parent": "",
   "name": "request", "start_ms": 12.3, "dur_ms": 4.5,
   "wall_start": 1754650000.123, "thread": "MainThread", "attrs": {...}}
  {"kind": "metrics", "snapshot": {...}}          # optional, at most one

``start_ms`` is milliseconds since the tracer's perf anchor (directly
comparable across every span in the file); ``wall_start`` anchors the
span to calendar time for correlation with external logs and
``torch.profiler`` trace directories.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Optional

from .trace import Span, Tracer

__all__ = ["SCHEMA_VERSION", "span_to_dict", "export_jsonl"]

SCHEMA_VERSION = 1


def span_to_dict(span: Span, perf_t0: float, wall_t0: float) -> dict:
    dur = span.t_end - span.t_start
    return {
        "kind": "span",
        "trace": span.trace_id,
        "span": span.span_id,
        "parent": span.parent_id,
        "name": span.name,
        "start_ms": round((span.t_start - perf_t0) * 1e3, 4),
        "dur_ms": round(dur * 1e3, 4) if dur == dur else None,
        "wall_start": round(wall_t0 + (span.t_start - perf_t0), 6),
        "thread": span.thread,
        "attrs": span.attrs,
    }


def export_jsonl(tracer: Tracer, path: str,
                 metrics_snapshot: Optional[dict] = None,
                 spans: Optional[Iterable[Span]] = None,
                 drain: bool = False) -> int:
    """Write the tracer's committed spans (or an explicit ``spans``
    iterable) to ``path``. Returns the number of span lines written.
    ``drain=True`` clears the tracer's buffer after export, so repeated
    exports from a long-lived process don't re-emit old spans."""
    if spans is None:
        spans = tracer.drain() if drain else tracer.spans()
    spans = sorted(spans, key=lambda s: (s.trace_id, s.t_start, s.span_id))
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    n = 0
    with open(path, "w") as fh:
        fh.write(json.dumps({
            "kind": "header", "schema": SCHEMA_VERSION,
            "wall_t0": round(tracer.wall_t0, 6),
            "perf_t0": tracer.perf_t0,
            "dropped": tracer.dropped, "n_spans": len(spans),
        }) + "\n")
        for sp in spans:
            fh.write(json.dumps(
                span_to_dict(sp, tracer.perf_t0, tracer.wall_t0),
                default=str) + "\n")
            n += 1
        if metrics_snapshot is not None:
            fh.write(json.dumps({"kind": "metrics",
                                 "snapshot": metrics_snapshot},
                                default=str) + "\n")
    return n

"""Read exported traces back: parse, build trees, render, roll up.

A copy of ``repro.obs.report``: the library behind
``repro_torch.launch.obs_report`` (the CLI). It works entirely on the
JSONL dicts written by :mod:`repro_torch.obs.export` (or the
reference's, which writes the same lines) — no live Tracer needed — so
a trace captured on the card can be rendered anywhere.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

__all__ = ["read_trace", "trace_ids", "trace_tree", "render_trace",
           "rollup", "render_rollup", "render_metrics"]


class TraceFileError(ValueError):
    """Raised on an empty, truncated, or schema-incompatible file."""


def read_trace(path: str) -> dict:
    """Parse a JSONL trace file into
    ``{"header": dict, "spans": [dict], "metrics": dict | None}``.
    Raises :class:`TraceFileError` on malformed input — CI treats that
    as a failed smoke, not a silent skip."""
    header, spans, metrics = None, [], None
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceFileError(
                    f"{path}:{lineno}: not JSON ({e})") from e
            kind = rec.get("kind")
            if kind == "header":
                header = rec
            elif kind == "span":
                for key in ("trace", "span", "name", "start_ms"):
                    if key not in rec:
                        raise TraceFileError(
                            f"{path}:{lineno}: span missing {key!r}")
                spans.append(rec)
            elif kind == "metrics":
                metrics = rec.get("snapshot")
            else:
                raise TraceFileError(
                    f"{path}:{lineno}: unknown kind {kind!r}")
    if header is None:
        raise TraceFileError(f"{path}: no header line")
    if int(header.get("schema", -1)) != 1:
        raise TraceFileError(
            f"{path}: unsupported schema {header.get('schema')!r}")
    return {"header": header, "spans": spans, "metrics": metrics}


def trace_ids(spans: List[dict]) -> List[str]:
    """Distinct trace IDs in first-appearance order."""
    seen: Dict[str, None] = {}
    for sp in spans:
        seen.setdefault(sp["trace"], None)
    return list(seen)


def trace_tree(spans: List[dict], trace_id: str) -> List[dict]:
    """Root span dicts of one trace, each with a ``children`` list
    (recursively), ordered by start time. Orphans (parent id missing
    from the file, e.g. dropped at the max_spans cap) are promoted to
    roots so they stay visible."""
    mine = [dict(sp) for sp in spans if sp["trace"] == trace_id]
    by_id = {sp["span"]: sp for sp in mine}
    for sp in mine:
        sp["children"] = []
    roots = []
    for sp in sorted(mine, key=lambda s: (s["start_ms"], s["span"])):
        parent = by_id.get(sp.get("parent") or "")
        if parent is None or parent is sp:
            roots.append(sp)
        else:
            parent["children"].append(sp)
    return roots


def _fmt_attrs(attrs: dict, limit: int = 4) -> str:
    if not attrs:
        return ""
    items = list(attrs.items())[:limit]
    body = ", ".join(f"{k}={v}" for k, v in items)
    if len(attrs) > limit:
        body += ", …"
    return f"  [{body}]"


def render_trace(spans: List[dict], trace_id: str) -> str:
    """ASCII tree of one trace, durations right where the eye lands:

        trace t000001
        └─ request                 4.513 ms  [tenant=t0, n=7]
           ├─ admit                0.021 ms
           ├─ queue                1.804 ms
           └─ batch                2.611 ms  [n_requests=2]
              └─ dispatch          2.498 ms
                 └─ device         2.441 ms
    """
    roots = trace_tree(spans, trace_id)
    if not roots:
        return f"trace {trace_id}: no spans"
    lines = [f"trace {trace_id}"]

    def emit(sp: dict, prefix: str, is_last: bool) -> None:
        branch = "└─ " if is_last else "├─ "
        dur = sp.get("dur_ms")
        dur_s = f"{dur:10.3f} ms" if dur is not None else "      open"
        label = f"{prefix}{branch}{sp['name']}"
        pad = max(1, 34 - len(label))
        lines.append(f"{label}{' ' * pad}{dur_s}"
                     f"{_fmt_attrs(sp.get('attrs') or {})}")
        child_prefix = prefix + ("   " if is_last else "│  ")
        kids = sp["children"]
        for i, child in enumerate(kids):
            emit(child, child_prefix, i == len(kids) - 1)

    for i, root in enumerate(roots):
        emit(root, "", i == len(roots) - 1)
    return "\n".join(lines)


def rollup(spans: List[dict]) -> Dict[str, dict]:
    """Per-span-name aggregate across every trace in the file:
    {name: {count, total_ms, p50_ms, p95_ms, max_ms}}, insertion order
    by first appearance. This is what BenchRun attaches to records."""
    groups: Dict[str, List[float]] = {}
    for sp in spans:
        dur = sp.get("dur_ms")
        if dur is None:
            continue
        groups.setdefault(sp["name"], []).append(float(dur))
    out = {}
    for name, durs in groups.items():
        arr = np.asarray(durs)
        out[name] = {
            "count": int(arr.size),
            "total_ms": round(float(arr.sum()), 3),
            "p50_ms": round(float(np.percentile(arr, 50)), 3),
            "p95_ms": round(float(np.percentile(arr, 95)), 3),
            "max_ms": round(float(arr.max()), 3),
        }
    return out


def render_rollup(spans: List[dict]) -> str:
    agg = rollup(spans)
    if not agg:
        return "no closed spans"
    name_w = max(len(n) for n in agg) + 2
    header = (f"{'span':<{name_w}}{'count':>7}{'total_ms':>11}"
              f"{'p50_ms':>9}{'p95_ms':>9}{'max_ms':>9}")
    lines = [header, "-" * len(header)]
    for name, s in sorted(agg.items(), key=lambda kv: -kv[1]["total_ms"]):
        lines.append(f"{name:<{name_w}}{s['count']:>7}"
                     f"{s['total_ms']:>11.3f}{s['p50_ms']:>9.3f}"
                     f"{s['p95_ms']:>9.3f}{s['max_ms']:>9.3f}")
    return "\n".join(lines)


def render_metrics(snapshot: Optional[dict]) -> str:
    if not snapshot:
        return "no metrics snapshot"
    lines = ["metrics snapshot"]
    for name, val in snapshot.items():
        if isinstance(val, dict):
            body = ", ".join(f"{k}={v}" for k, v in val.items())
            lines.append(f"  {name}: {body}")
        else:
            lines.append(f"  {name}: {val}")
    return "\n".join(lines)

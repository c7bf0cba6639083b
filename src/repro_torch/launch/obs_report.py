"""Render an exported obs trace: tree per trace + rollup + metrics.

    PYTHONPATH=src python -m repro_torch.launch.obs_report traces/train_pipeline.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obs_report TRACE --trace-id t000001
    PYTHONPATH=src python -m repro_torch.launch.obs_report TRACE --rollup

A port of ``repro.launch.obs_report``: the same text for the same file.
Exits nonzero when the file is missing, malformed, or contains no spans
(the "tracing actually produced a well-formed trace" assertion).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.obs.report import (TraceFileError, read_trace,
                                   render_metrics, render_rollup,
                                   render_trace, trace_ids)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="obs_report",
        description="Render a repro_torch.obs JSONL trace export.")
    p.add_argument("trace_file", help="JSONL file written by repro_torch.obs")
    p.add_argument("--trace-id", default=None,
                   help="render only this trace (default: all, "
                        "up to --limit)")
    p.add_argument("--limit", type=int, default=8,
                   help="max traces to render as trees (default 8)")
    p.add_argument("--rollup", action="store_true",
                   help="only the per-span-name aggregate table")
    p.add_argument("--no-metrics", action="store_true",
                   help="skip the metrics snapshot section")
    return p


def report(path: str, trace_id: str = None, limit: int = 8,
           rollup_only: bool = False, show_metrics: bool = True) -> str:
    """The full report as a string."""
    data = read_trace(path)
    spans = data["spans"]
    if not spans:
        raise TraceFileError(f"{path}: no spans recorded")
    header = data["header"]
    out = [f"{path}: {len(spans)} spans, "
           f"{len(trace_ids(spans))} traces, schema {header['schema']}"
           + (f", {header['dropped']} dropped" if header.get("dropped")
              else "")]
    if not rollup_only:
        ids = [trace_id] if trace_id else trace_ids(spans)[:limit]
        for tid in ids:
            out.append("")
            out.append(render_trace(spans, tid))
        n_total = len(trace_ids(spans))
        if not trace_id and n_total > limit:
            out.append(f"... {n_total - limit} more traces "
                       f"(--limit to show)")
    out.append("")
    out.append(render_rollup(spans))
    if show_metrics and data["metrics"] is not None:
        out.append("")
        out.append(render_metrics(data["metrics"]))
    return "\n".join(out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        text = report(args.trace_file, trace_id=args.trace_id,
                      limit=args.limit, rollup_only=args.rollup,
                      show_metrics=not args.no_metrics)
    except (OSError, TraceFileError) as e:
        print(f"obs_report: {e}", file=sys.stderr)
        return 1
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

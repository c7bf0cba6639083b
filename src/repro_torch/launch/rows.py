"""The CSV rows the benches and the paper suite print:
``name,us_per_call,derived`` (a copy of ``benchmarks.common.Row``)."""
from __future__ import annotations

__all__ = ["Row"]


class Row:
    """CSV row accumulator: name,us_per_call,derived."""

    def __init__(self):
        self.rows = []

    def add(self, name: str, us_per_call: float, **derived):
        d = ";".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in derived.items())
        self.rows.append((name, us_per_call, d))
        print(f"{name},{us_per_call:.1f},{d}", flush=True)
        return self

    def emit(self):
        return self.rows

"""Stream telemetry for the swap-capable session and the replay loop
(port of ``repro.serve.telemetry.StreamTelemetry``).

One ``StreamTelemetry`` is shared between a capacity-padded
``RecsysSession`` (swap latency, capacity bumps) and the stream updater's
replay loop (appends, cold assigns, refreshes, label churn). Its
counters and ``summary()`` keys are the reference's. The reference
counts compiled programs to show that a swap compiles nothing; the port
runs eagerly, and its session counts ``state_allocations`` instead
(``RecsysSession.stats()``): a swap within the capacity rungs allocates
no device state.
"""
from __future__ import annotations

from repro_torch.obs.metrics import CounterSet, LatencyRecorder

__all__ = ["LatencyRecorder", "StreamTelemetry"]


class StreamTelemetry:
    """Counters for the online co-clustering / hot-swap pipeline."""

    def __init__(self):
        self.swap = LatencyRecorder()              # ms per session.swap
        self.counters = CounterSet(("appends", "new_edges", "cold_users",
                                    "cold_items", "refreshes",
                                    "capacity_bumps"))
        # per-refresh label churn: running mean + last, not a list
        self._churn_sum = 0.0
        self._churn_n = 0
        self._churn_last = float("nan")

    def bump(self, name: str, n: int = 1) -> None:
        self.counters.bump(name, n)

    def record_churn(self, fraction: float) -> None:
        f = float(fraction)
        self._churn_sum += f
        self._churn_n += 1
        self._churn_last = f

    def summary(self) -> dict:
        out = self.counters.as_dict()
        out["swaps"] = self.swap.count
        out["swap_p50_ms"] = round(self.swap.percentile(50), 3)
        out["swap_p99_ms"] = round(self.swap.percentile(99), 3)
        out["churn_mean"] = (round(self._churn_sum / self._churn_n, 4)
                             if self._churn_n else float("nan"))
        out["churn_last"] = (round(self._churn_last, 4)
                             if self._churn_n else float("nan"))
        return out

"""Stream and front-end telemetry (port of ``repro.serve.telemetry``'s
``StreamTelemetry`` and ``FrontdoorTelemetry``).

One ``StreamTelemetry`` is shared between a capacity-padded
``RecsysSession`` (swap latency, capacity bumps) and the stream updater's
replay loop (appends, cold assigns, refreshes, label churn). Its
counters and ``summary()`` keys are the reference's. The reference
counts compiled programs to show that a swap compiles nothing; the port
runs eagerly, and its session counts ``state_allocations`` instead
(``RecsysSession.stats()``): a swap within the capacity rungs allocates
no device state.

One ``FrontdoorTelemetry`` belongs to each ``repro_torch.frontdoor.
Frontdoor``: end-to-end and queue-delay percentiles, batch fill and
per-bucket occupancy, shed/timeout/cache counters, and the swap pause
under load. Its ``summary()`` keys and rounding are the reference's.
"""
from __future__ import annotations

from repro_torch.obs.metrics import CounterSet, LatencyRecorder

__all__ = ["LatencyRecorder", "StreamTelemetry", "FrontdoorTelemetry"]


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


class FrontdoorTelemetry:
    """Counters for the async serving front end (one per Frontdoor).

    Latency recorders (all milliseconds):
      e2e         submit -> response (what a caller experiences)
      queue_delay submit -> batch dispatch (time spent waiting to be
                  coalesced; the batcher's flush rule bounds this at
                  low load, the queue bound at overload)
      swap_pause  swap request -> completion under load: drain wait for
                  the in-flight batch PLUS the session swap itself

    ``record_batch`` tracks how well the continuous batcher packs the
    bucket ladder: fill ratio = real ids / padded ids, and per-bucket
    occupancy counts. Counters: requests, responses, batches, coalesced
    (requests that shared a batch with another), shed (admission
    refused), timeouts (expired in queue), cache_hits, swaps, errors.
    """

    def __init__(self):
        self.e2e = LatencyRecorder()
        self.queue_delay = LatencyRecorder()
        self.swap_pause = LatencyRecorder()
        self.counters = CounterSet(("requests", "responses", "batches",
                                    "coalesced", "shed", "timeouts",
                                    "cache_hits", "swaps", "errors"))
        # batch-fill ratio: running mean, not a per-batch list
        self._fill_sum = 0.0
        self._fill_n = 0
        self.bucket_counts: dict = {}

    def bump(self, name: str, n: int = 1) -> None:
        self.counters.bump(name, n)

    def record_batch(self, n_requests: int, n_ids: int, n_padded: int,
                     buckets_used) -> None:
        """One dispatched batch: ``n_requests`` coalesced requests
        totalling ``n_ids`` real rows, padded to ``n_padded`` rows
        across ``buckets_used`` ladder rungs."""
        self.counters.bump("batches")
        if n_requests > 1:
            self.counters.bump("coalesced", n_requests)
        self._fill_sum += n_ids / max(n_padded, 1)
        self._fill_n += 1
        for b in buckets_used:
            self.bucket_counts[int(b)] = self.bucket_counts.get(int(b), 0) + 1

    def summary(self) -> dict:
        out = self.counters.as_dict()
        out["e2e_p50_ms"] = round(self.e2e.percentile(50), 3)
        out["e2e_p99_ms"] = round(self.e2e.percentile(99), 3)
        out["queue_delay_p50_ms"] = round(self.queue_delay.percentile(50), 3)
        out["queue_delay_p99_ms"] = round(self.queue_delay.percentile(99), 3)
        out["batch_fill_mean"] = (round(self._fill_sum / self._fill_n, 4)
                                  if self._fill_n else float("nan"))
        out["bucket_counts"] = dict(sorted(self.bucket_counts.items()))
        out["swap_pause_p50_ms"] = round(self.swap_pause.percentile(50), 3)
        out["swap_pause_p99_ms"] = round(self.swap_pause.percentile(99), 3)
        return out

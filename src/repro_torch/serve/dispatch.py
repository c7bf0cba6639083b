"""BatchDispatcher: fixed bucket ladder over variable-size traffic (port
of ``repro.serve.dispatch``).

Every request is padded up to the smallest bucket that fits (with id 0,
a valid row; scoring is row-independent), and outputs are sliced back to
the true size, so the session sees at most ``len(buckets)`` batch
shapes. Requests larger than the top bucket are chunked: full top-bucket
chunks plus one bucketed remainder, concatenated in order. Padding and
slicing happen host-side, and the dispatcher returns numpy arrays.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.obs import LatencyRecorder, clock

__all__ = ["BatchDispatcher", "DEFAULT_BUCKETS", "chunk_plan"]

DEFAULT_BUCKETS = (1, 8, 64, 512)


def chunk_plan(n: int, buckets: Sequence[int]):
    """[(size, bucket), ...] covering a request of ``n`` rows: full
    top-bucket chunks plus one bucketed remainder."""
    if n < 1:
        raise ValueError("empty request")
    top = buckets[-1]
    plan = []
    start = 0
    while start < n:
        m = min(n - start, top)
        plan.append((m, next(b for b in buckets if m <= b)))
        start += m
    return plan


class BatchDispatcher:
    """Fronts a session with a padded bucket ladder.

    session:  anything with the session protocol whose __call__ takes a
              rank-1 int id array and returns a tuple of tensors with a
              leading batch dim (RecsysSession).
    buckets:  ascending batch sizes (deduplicated).
    """

    def __init__(self, session, buckets: Sequence[int] = DEFAULT_BUCKETS):
        self.session = session
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        self._lat = LatencyRecorder()
        self._bucket_counts = {b: 0 for b in self.buckets}

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits n (n must be <= the top bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch {n} exceeds top bucket {self.buckets[-1]}")

    def warmup(self) -> None:
        """Run every rung of the ladder once (untimed)."""
        for b in self.buckets:
            self.session.warmup(b)

    def __call__(self, user_ids):
        """Serve one request of any size >= 1; returns numpy arrays
        sliced to the true size."""
        user_ids = np.asarray(user_ids, np.int32)
        n = int(user_ids.shape[0])
        t0 = clock.now()
        outs = []
        start = 0
        for m, bucket in chunk_plan(n, self.buckets):
            chunk = user_ids[start:start + m]
            if m < bucket:
                chunk = np.concatenate(
                    [chunk, np.zeros((bucket - m,), np.int32)])
            out = self.session(chunk)
            outs.append(tuple(x.cpu().numpy()[:m] for x in out))
            self._bucket_counts[bucket] += 1
            start += m
        self._lat.record(clock.ms_between(t0, clock.now()))
        if len(outs) == 1:
            return outs[0]
        return tuple(np.concatenate(xs, axis=0) for xs in zip(*outs))

    def stats(self) -> dict:
        """Dispatcher latency (whole requests, chunking included) plus
        bucket usage and the session's telemetry."""
        return {"buckets": list(self.buckets),
                "bucket_counts": dict(self._bucket_counts),
                **self._lat.summary(),
                "session": self.session.stats()}

"""ContinuousBatcher: the single consumer between the queue and the
device (port of ``repro.frontdoor.batcher``).

Serving traffic arrives as many small concurrent requests; the device
wants few large fixed-shape batches. The batcher bridges them with a
continuous (dynamic) batching loop:

    drain the admission queue -> group requests by tenant -> flush a
    group when it is FULL (>= the top bucket: the device batch cannot
    get better-packed) or when its oldest request has waited flush_ms
    (the DEADLINE: low-load requests must not sit waiting for a batch
    that will never fill)

The deadline-or-full rule is what keeps p50 honest at low load — a lone
request pays at most flush_ms of coalescing wait, not a full-bucket
wait — while under load batches fill before the deadline and the device
sees top-bucket shapes (fill ratio ~1, tracked in telemetry).

Flushed groups dispatch through the tenant's BatchDispatcher (the
bucket ladder), so the session sees at most len(buckets) batch shapes
whatever the traffic. Requests whose
per-request deadline expired in the queue are rejected at flush time
WITHOUT scoring (a timed-out caller is gone; scoring for it would steal
device time from live requests).

Dispatches run under the Frontdoor's dispatch lock. That lock is the
swap-drain mechanism: ``Frontdoor.swap`` takes it, so a swap waits for
the in-flight batch to finish on the old version, and every batch
flushed after the swap resolves tenant -> session AT FLUSH TIME and
serves the new one.

On a CUDA device every dispatch also runs on the Frontdoor's own CUDA
stream (``torch.cuda.stream``), the stream ``swap`` and ``attach``
enqueue their copies and warmups on: PyTorch's current stream is per
thread, and one stream under one lock orders a swap's in-place copies
after the last batch on the old version and before the first on the
new, whichever thread calls what.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serve.dispatch import chunk_plan
from repro_torch.serve.telemetry import FrontdoorTelemetry

from .request import DeadlineExceeded, Request

__all__ = ["BatcherConfig", "ContinuousBatcher"]

_STOP = object()


@dataclasses.dataclass
class BatcherConfig:
    flush_ms: float = 2.0       # max coalescing wait for the oldest request
    max_batch: Optional[int] = None   # flush-when-full size; default: the
    #                                   registry ladder's top bucket
    idle_poll_ms: float = 50.0  # queue poll period when nothing is pending


class ContinuousBatcher:
    """Owns the consumer thread; see module docstring for the loop.

    queue:          the Frontdoor's bounded admission queue
    registry:       TenantRegistry (tenant -> dispatcher, resolved at
                    flush time)
    telemetry:      FrontdoorTelemetry
    cache:          optional HotUserCache, populated under the dispatch
                    lock (so swap's invalidate can never race a stale
                    re-fill)
    dispatch_lock:  the Frontdoor's swap-drain lock
    stream:         the Frontdoor's CUDA stream (None on the CPU):
                    dispatches are enqueued on it
    """

    def __init__(self, queue, registry, telemetry: FrontdoorTelemetry,
                 cache=None, dispatch_lock: Optional[threading.Lock] = None,
                 cfg: Optional[BatcherConfig] = None,
                 tracer: Optional[Tracer] = None,
                 stream: Optional[torch.cuda.Stream] = None):
        self._queue = queue
        self._registry = registry
        self._tele = telemetry
        self._cache = cache
        self._lock = dispatch_lock or threading.Lock()
        self._stream = stream
        self.cfg = cfg or BatcherConfig()
        self._tracer = tracer or get_tracer()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._thread = threading.Thread(target=self._loop,
                                        name="frontdoor-batcher",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful: queued and pending requests are flushed (served)
        before the thread exits."""
        if not self.running:
            return
        self._queue.put(_STOP)
        self._thread.join(timeout)
        self._thread = None

    # -- the loop -----------------------------------------------------------
    def _max_batch(self, tenant: str) -> int:
        if self.cfg.max_batch is not None:
            return int(self.cfg.max_batch)
        # the registry-level ladder, NOT the tenant's dispatcher: this
        # runs outside the dispatch lock, and tenant -> session keys
        # move mid-swap (resolving here raced a concurrent swap once;
        # every pooled dispatcher is built with this ladder anyway)
        return max(self._registry.buckets)

    def _loop(self) -> None:
        flush_s = self.cfg.flush_ms / 1e3
        pending = {}                 # tenant -> [Request] in arrival order
        stopping = False
        while True:
            # wait bounded by the nearest pending flush deadline
            if pending:
                oldest = min(reqs[0].t_submit for reqs in pending.values())
                timeout = max(0.0, oldest + flush_s - clock.now())
            else:
                timeout = self.cfg.idle_poll_ms / 1e3
            item = None
            if not stopping:
                try:
                    item = self._queue.get(timeout=timeout)
                except queue_mod.Empty:
                    item = None
            if item is _STOP:
                stopping = True
                # drain whatever raced in behind the sentinel
                while True:
                    try:
                        extra = self._queue.get_nowait()
                    except queue_mod.Empty:
                        break
                    if extra is not _STOP:
                        pending.setdefault(extra.tenant, []).append(extra)
            elif item is not None:
                pending.setdefault(item.tenant, []).append(item)
            # flush every group that is full or past its deadline
            # (stopping: flush everything — graceful shutdown serves
            # what was admitted)
            now = clock.now()
            for tenant in list(pending):
                reqs = pending[tenant]
                total = sum(r.n for r in reqs)
                if (stopping or total >= self._max_batch(tenant)
                        or now - reqs[0].t_submit >= flush_s):
                    del pending[tenant]
                    self._flush(tenant, reqs)
            if stopping and not pending:
                return

    def _flush(self, tenant: str, reqs) -> None:
        now = clock.now()
        live = []
        for r in reqs:
            if r.expired(now):
                self._tele.bump("timeouts")
                if r.span is not None:
                    r.span.end(outcome="timeout")
                r.ticket.reject(DeadlineExceeded(
                    f"request expired in queue after "
                    f"{(now - r.t_submit) * 1e3:.1f}ms"))
            else:
                live.append(r)
        if not live:
            return
        # requests whose trace was sampled get retroactive queue /
        # batch / dispatch / device / respond spans committed below;
        # with tracing off every r.span is the no-op NULL_SPAN
        traced = [r for r in live
                  if r.span is not None and r.span.sampled]
        ids = np.concatenate([r.user_ids for r in live])
        with self._lock, torch.cuda.stream(self._stream):
            t_dispatch = clock.now()
            try:
                disp = self._registry.dispatcher(tenant)
                t_dev0 = clock.now()
                values, items = disp(ids)
                t_dev1 = clock.now()
            except Exception as exc:
                self._tele.bump("errors", len(live))
                for r in live:
                    if r.span is not None:
                        r.span.end(outcome="error",
                                   error=type(exc).__name__)
                    r.ticket.reject(exc)
                return
            if self._cache is not None:
                self._cache.put(tenant, ids, values, items)
        t_done = clock.now()
        plan = chunk_plan(int(ids.shape[0]), disp.buckets)
        n_padded = sum(b for _, b in plan)
        self._tele.record_batch(len(live), int(ids.shape[0]),
                                n_padded, [b for _, b in plan])
        for r in traced:
            tr = self._tracer
            tr.record_span("queue", r.t_submit, t_dispatch, parent=r.span)
            batch = tr.record_span("batch", t_dispatch, t_done,
                                   parent=r.span, n_requests=len(live),
                                   n_ids=int(ids.shape[0]),
                                   n_padded=n_padded)
            disp_sp = tr.record_span("dispatch", t_dispatch, t_dev1,
                                     parent=batch, tenant=tenant)
            tr.record_span("device", t_dev0, t_dev1, parent=disp_sp)
        offset = 0
        for r in live:
            self._tele.queue_delay.record((t_dispatch - r.t_submit) * 1e3)
            t_r0 = clock.now()
            r.ticket.resolve((values[offset:offset + r.n],
                              items[offset:offset + r.n]))
            t_r1 = clock.now()
            self._tele.e2e.record((t_r1 - r.t_submit) * 1e3)
            self._tele.bump("responses")
            if r.span is not None and r.span.sampled:
                self._tracer.record_span("respond", t_r0, t_r1,
                                         parent=r.span)
                r.span.end(outcome="ok")
            offset += r.n

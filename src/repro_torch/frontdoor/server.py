"""Frontdoor: the async serving front end (port of
``repro.frontdoor.server``).

One object ties the subsystem together around a single data path:

    submit() -> [hot-user cache] -> bounded admission queue
             -> ContinuousBatcher (deadline-or-full coalescing)
             -> TenantRegistry session (bucket-ladder dispatch)
             -> Ticket.result()

Admission control and backpressure: the queue is bounded
(``queue_size``); when it is full the configured policy decides —
``"shed"`` rejects the request immediately (RequestShed, counted; the
production default: fail fast and let the caller retry elsewhere) while
``"block"`` makes ``submit`` wait for space (backpressure propagates to
the caller's thread; the batch-job default). Each request may carry a
deadline budget; requests that expire in the queue are rejected at
flush time without scoring.

Hot swap under load: ``swap(tenant, artifact)`` takes the dispatch lock,
so the in-flight batch finishes on the old version (drain), then the
registry moves the tenant (repoint / in-place swap / attach) and the
tenant's cache shard is invalidated — all before the next batch
dispatches. The full pause (drain wait + session swap) is recorded as
``swap_pause`` — the under-fire number an idle swap's time understates.

Everything is instrumented through one FrontdoorTelemetry; ``stats()``
merges it with the registry's session view. The allocation invariant
survives the whole stack: warmed sessions serve ANY traffic pattern,
in-place swaps included, without allocating device state while it fits
the capacity ladder (``state_allocations`` stays put; the reference
counts compiled XLA programs in its place).

The CUDA stream: the Frontdoor owns one ``torch.cuda.Stream`` on its
device (none on the CPU). The batcher's dispatches, and ``swap`` and
``attach`` with their warmups, run on it under the dispatch lock,
whatever thread calls them: a session's in-place copies
(``DeviceState.fill``) are enqueued on the current stream, which
PyTorch keeps per thread.

Tracing: ``submit`` opens a per-request root span ("request") with an
"admit" child on the caller thread and hands the root to the batcher on
the Request; the batcher attributes queue/batch/dispatch/device/respond
time retroactively and closes the root (see ContinuousBatcher._flush).
With the ambient tracer disabled — the default — every span call is the
shared no-op NULL_SPAN.
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import clock
from repro_torch.obs.trace import Tracer, get_tracer
from repro_torch.serve import DEFAULT_BUCKETS
from repro_torch.serve.telemetry import FrontdoorTelemetry

from .batcher import BatcherConfig, ContinuousBatcher
from .cache import HotUserCache
from .request import Request, RequestShed, Ticket
from .tenants import TenantRegistry

__all__ = ["FrontdoorConfig", "Frontdoor"]

_POLICIES = ("shed", "block")


@dataclasses.dataclass
class FrontdoorConfig:
    queue_size: int = 512            # admission bound (requests)
    policy: str = "shed"             # full-queue behavior: shed | block
    flush_ms: float = 2.0            # batcher coalescing deadline
    max_batch: Optional[int] = None  # flush-when-full size (default: top
    #                                  bucket of the tenant's ladder)
    default_deadline_ms: Optional[float] = None  # per-request budget
    cache_entries: int = 0           # hot-user cache capacity (0 = off)
    k: int = 20                      # top-k served
    buckets: tuple = DEFAULT_BUCKETS
    backend: Optional[str] = None    # EmbeddingEngine lookup backend
    scorer: Optional[str] = None     # dense | fused
    capacity: Optional[dict] = None  # session capacity ladder (swaps)
    device: str = "cuda"             # where sessions live (raises
    #                                  without a GPU unless "cpu")

    def __post_init__(self):
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown admission policy {self.policy!r}; "
                             f"expected {'|'.join(_POLICIES)}")


class Frontdoor:
    """The serving front end; see module docstring for the data path.

    Lifecycle: attach tenants, ``start()``, submit traffic, ``stop()``
    (graceful: admitted requests are served before the batcher exits).
    Usable as a context manager.
    """

    def __init__(self, cfg: Optional[FrontdoorConfig] = None,
                 registry: Optional[TenantRegistry] = None,
                 telemetry: Optional[FrontdoorTelemetry] = None,
                 tracer: Optional[Tracer] = None):
        self.cfg = cfg or FrontdoorConfig()
        self.device = resolve_device(self.cfg.device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self.registry = registry or TenantRegistry(
            k=self.cfg.k, capacity=self.cfg.capacity,
            backend=self.cfg.backend, scorer=self.cfg.scorer,
            buckets=self.cfg.buckets, device=self.device)
        self.telemetry = telemetry or FrontdoorTelemetry()
        self.tracer = tracer or get_tracer()
        self._queue = queue_mod.Queue(maxsize=self.cfg.queue_size)
        self._cache = (HotUserCache(self.cfg.cache_entries)
                       if self.cfg.cache_entries else None)
        self._dispatch_lock = threading.Lock()
        self._batcher = ContinuousBatcher(
            self._queue, self.registry, self.telemetry, cache=self._cache,
            dispatch_lock=self._dispatch_lock,
            cfg=BatcherConfig(flush_ms=self.cfg.flush_ms,
                              max_batch=self.cfg.max_batch),
            tracer=self.tracer, stream=self.stream)
        self._accepting = False

    # -- lifecycle ----------------------------------------------------------
    def attach(self, name: str, artifact, capacity=None,
               warmup: bool = True):
        """Register a tenant (see TenantRegistry.attach); a session it
        builds is uploaded and warmed on the Frontdoor's stream."""
        with self._dispatch_lock, torch.cuda.stream(self.stream):
            return self.registry.attach(name, artifact, capacity=capacity,
                                        warmup=warmup)

    def attach_session(self, name: str, session, artifact_id: str,
                       n_users: int = 0):
        with self._dispatch_lock:
            return self.registry.attach_session(name, session, artifact_id,
                                                n_users=n_users)

    def start(self) -> "Frontdoor":
        self._batcher.start()
        self._accepting = True
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Stop admission, then drain: every admitted request is served
        before the batcher thread exits."""
        self._accepting = False
        self._batcher.stop(timeout=timeout)

    def __enter__(self) -> "Frontdoor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def running(self) -> bool:
        return self._batcher.running and self._accepting

    # -- the request path ---------------------------------------------------
    def submit(self, user_ids, tenant: str = "default",
               deadline_ms: Optional[float] = None) -> Ticket:
        """Enqueue one request; returns its Ticket immediately.

        Raises RequestShed when the queue is full under the "shed"
        policy (under "block" the call waits for space instead —
        backpressure). A full-hit request is answered from the hot-user
        cache without touching the queue at all.
        """
        ids = np.asarray(user_ids, np.int32).ravel()
        if ids.size == 0:
            raise ValueError("empty request")
        self.registry.tenant(tenant)            # unknown tenant: fail now
        if not self.running:
            raise RuntimeError("Frontdoor is not accepting requests "
                               "(call start(), and stop() only when done)")
        t_submit = clock.now()
        root = self.tracer.trace("request", tenant=tenant, n=int(ids.size))
        self.telemetry.bump("requests")
        with self.tracer.span("admit", parent=root) as admit:
            if self._cache is not None:
                hit = self._cache.get(tenant, ids)
                if hit is not None:
                    self.telemetry.bump("cache_hits")
                    self.telemetry.bump("responses")
                    ticket = Ticket()
                    ticket.resolve(hit)
                    self.telemetry.e2e.record(
                        (clock.now() - t_submit) * 1e3)
                    admit.set(outcome="cache_hit")
                    root.end(outcome="cache_hit")
                    return ticket
            if deadline_ms is None:
                deadline_ms = self.cfg.default_deadline_ms
            deadline = (t_submit + deadline_ms / 1e3
                        if deadline_ms is not None else None)
            req = Request(user_ids=ids, tenant=tenant, ticket=Ticket(),
                          t_submit=t_submit, deadline=deadline, span=root)
            try:
                if self.cfg.policy == "shed":
                    self._queue.put_nowait(req)
                else:
                    self._queue.put(req)
            except queue_mod.Full:
                self.telemetry.bump("shed")
                admit.set(outcome="shed")
                root.end(outcome="shed")
                raise RequestShed(
                    f"admission queue full ({self.cfg.queue_size} "
                    f"requests); policy=shed rejects instead of queueing "
                    f"further") from None
        return req.ticket

    def __call__(self, user_ids, tenant: str = "default",
                 deadline_ms: Optional[float] = None,
                 timeout: Optional[float] = 60.0):
        """Synchronous convenience: submit + wait for the response."""
        return self.submit(user_ids, tenant=tenant,
                           deadline_ms=deadline_ms).result(timeout=timeout)

    # -- control plane ------------------------------------------------------
    def swap(self, tenant: str, artifact) -> dict:
        """Move a live tenant to a new artifact version under load:
        drain the in-flight batch (dispatch lock), swap/repoint/attach
        in the registry, invalidate the tenant's cache shard, all on the
        Frontdoor's stream. Returns the registry's swap record plus the
        measured full pause."""
        t0 = clock.now()
        with self.tracer.span("frontdoor_swap", tenant=tenant) as sp:
            with self._dispatch_lock, torch.cuda.stream(self.stream):
                t_drained = clock.now()
                self.tracer.record_span("drain", t0, t_drained, parent=sp)
                with self.tracer.span("registry_swap", parent=sp):
                    out = self.registry.swap(tenant, artifact)
                if self._cache is not None:
                    out["cache_invalidated"] = self._cache.invalidate(tenant)
        pause_ms = (clock.now() - t0) * 1e3
        self.telemetry.swap_pause.record(pause_ms)
        self.telemetry.bump("swaps")
        out["pause_ms"] = round(pause_ms, 3)
        out["drain_ms"] = round((t_drained - t0) * 1e3, 3)
        return out

    # -- telemetry ----------------------------------------------------------
    @property
    def state_allocations(self) -> int:
        return self.registry.state_allocations

    def queue_depth(self) -> int:
        return self._queue.qsize()

    def stats(self) -> dict:
        return {
            "policy": self.cfg.policy,
            "queue_size": self.cfg.queue_size,
            "flush_ms": self.cfg.flush_ms,
            "queue_depth": self.queue_depth(),
            "cache_entries": (len(self._cache)
                              if self._cache is not None else 0),
            **self.telemetry.summary(),
            "registry": self.registry.stats(),
        }

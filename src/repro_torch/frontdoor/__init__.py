"""repro_torch.frontdoor — async serving front end with continuous
batching (port of ``repro.frontdoor``, over the port's sessions).

Everything below ``CompressedArtifact`` serves one synchronous caller
(``RecsysSession`` + ``BatchDispatcher``); this package is the traffic
layer a real deployment puts in front of it:

  * ``Frontdoor`` — bounded admission queue (shed-or-block
    backpressure), per-request deadline budgets, a hot-user response
    cache, and drain-then-swap version changes measured UNDER load.
  * ``ContinuousBatcher`` — one consumer thread coalescing concurrent
    requests into the bucket ladder with a deadline-or-full flush rule
    (low-load p50 pays at most ``flush_ms``, loaded batches fill to the
    top bucket).
  * ``TenantRegistry`` — many logical tenants over few device-resident
    sessions, pooled by artifact ``content_id()``; swaps repoint, hot
    swap in place (copies into the session's device tensors), or
    attach, cheapest first.
  * ``loadgen`` — the open-loop traffic model (Poisson/bursty arrivals,
    Zipf users, mixed sizes) behind ``repro_torch.launch.load_bench``.

Sessions live on ``FrontdoorConfig.device`` ("cuda" unless the caller
asks for "cpu"); on the GPU the Frontdoor owns the one CUDA stream its
dispatches, swaps and warmups run on.

Usage — attach, start, drive::

    from repro_torch.frontdoor import Frontdoor, FrontdoorConfig

    fd = Frontdoor(FrontdoorConfig(queue_size=256, flush_ms=2.0,
                                   cache_entries=2048,
                                   capacity={"n_users": 100_000}))
    fd.attach("web", artifact)          # tenants sharing an artifact
    fd.attach("mobile", artifact)       # share ONE device session
    with fd:
        ticket = fd.submit([1, 2, 3], tenant="web", deadline_ms=50)
        values, items = ticket.result()
        fd.swap("web", new_artifact)    # drained, under load, counted
    print(fd.stats())                   # e2e/queue p50/p99, fill, sheds

CLI: ``python -m repro_torch.launch.frontdoor``; bench:
``python -m repro_torch.launch.load_bench --json``.
"""
from .batcher import BatcherConfig, ContinuousBatcher
from .cache import HotUserCache
from .loadgen import TrafficConfig, run_open_loop
from .request import DeadlineExceeded, Request, RequestShed, Ticket
from .server import Frontdoor, FrontdoorConfig
from .tenants import Tenant, TenantRegistry

__all__ = ["BatcherConfig", "ContinuousBatcher", "HotUserCache",
           "TrafficConfig", "run_open_loop", "DeadlineExceeded", "Request",
           "RequestShed", "Ticket", "Frontdoor", "FrontdoorConfig",
           "Tenant", "TenantRegistry"]

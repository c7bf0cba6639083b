"""Open-loop load generation for the serving front end (port of
``repro.frontdoor.loadgen``; the same draws from the same seed).

Closed-loop load (send, wait, repeat) measures the server at its own
pace and hides queueing entirely; an open-loop
generator submits at scheduled wall-clock arrival times whether or not
earlier requests finished, which is how production traffic behaves and
the only way queue delay, admission sheds and tail latency become
visible. Arrivals never wait for responses, but latency is measured
from the actual submit (as in the reference), so coordinated omission
is avoided only while the submitter keeps to its schedule: an action
it runs (a mid-load swap) delays the arrivals due meanwhile, and their
wait is not in the e2e figures.

Traffic model, per the workloads recommenders actually see:

  * arrivals: Poisson at ``qps``, optionally with bursty phases — the
    rate multiplied by ``burst_factor`` for ``burst_frac`` of each
    ``burst_period_s`` (thundering-herd windows);
  * user popularity: Zipf(``zipf_a``) over each tenant's universe, so
    a hot head dominates (what the response cache exists for);
  * request sizes: drawn from ``sizes`` (mixed small batches, the
    dispatcher ladder's job);
  * tenants: round-robin weighted by ``tenant_weights``.

``run_open_loop`` drives a started Frontdoor with one submitter thread,
optionally firing ``actions`` (e.g. a hot swap) at scheduled offsets
mid-load, and returns an aggregate report (sustained QPS, e2e/queue
percentiles from the server's FrontdoorTelemetry, per-outcome counts).
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs import clock

from .request import DeadlineExceeded, RequestShed

__all__ = ["TrafficConfig", "arrival_times", "zipf_ids", "run_open_loop"]


@dataclasses.dataclass
class TrafficConfig:
    qps: float = 200.0
    duration_s: float = 5.0
    sizes: Sequence[int] = (1, 1, 1, 2, 4, 8)   # mixed request sizes
    zipf_a: float = 1.1                          # user popularity skew
    burst_factor: float = 1.0                    # >1 enables bursty phases
    burst_frac: float = 0.25     # fraction of each period spent bursting
    burst_period_s: float = 1.0
    deadline_ms: Optional[float] = None          # per-request budget
    seed: int = 0


def arrival_times(cfg: TrafficConfig, rng) -> np.ndarray:
    """Poisson arrival offsets (seconds) over the run, thinned/boosted
    into bursty phases when burst_factor > 1.

    Drawn at the peak rate then thinned outside burst windows — exact
    for a piecewise-constant-rate Poisson process."""
    peak = cfg.qps * max(cfg.burst_factor, 1.0)
    n = max(1, int(np.ceil(peak * cfg.duration_s * 1.5)) + 16)
    t = np.cumsum(rng.exponential(1.0 / peak, size=n))
    t = t[t < cfg.duration_s]
    if cfg.burst_factor > 1.0:
        phase = np.mod(t, cfg.burst_period_s) / cfg.burst_period_s
        in_burst = phase < cfg.burst_frac
        keep = in_burst | (rng.random(t.size) < 1.0 / cfg.burst_factor)
        t = t[keep]
    return t


@functools.lru_cache(maxsize=8)
def _popularity_order(n_users: int) -> np.ndarray:
    """The fixed rank -> user id permutation of a universe (read-only:
    every caller shares it)."""
    perm = np.random.default_rng(12345).permutation(n_users)
    perm.flags.writeable = False
    return perm


def zipf_ids(rng, n: int, n_users: int, a: float) -> np.ndarray:
    """``n`` user ids Zipf(a)-distributed over [0, n_users): rank r is
    drawn with probability ~ 1/r^a, then ranks are mapped through a
    fixed permutation so popularity is not id-ordered. The permutation
    depends on ``n_users`` alone and is built once per universe (a
    permutation of 52,643 users a request would cap the submitter
    thread's rate and hold the interpreter lock against the batcher);
    the ids drawn are the reference's, draw for draw."""
    ranks = rng.zipf(max(a, 1.0 + 1e-9), size=n)
    ranks = np.minimum(ranks, n_users) - 1
    return _popularity_order(int(n_users))[ranks].astype(np.int32)


def run_open_loop(frontdoor, cfg: TrafficConfig,
                  tenants: Optional[Sequence[str]] = None,
                  tenant_weights: Optional[Sequence[float]] = None,
                  actions: Sequence[Tuple[float, Callable[[], object]]] = (),
                  result_timeout: float = 60.0,
                  log: Optional[list] = None) -> dict:
    """Drive ``frontdoor`` with open-loop traffic; returns the report.

    actions: [(offset_s, fn), ...] fired (once each, in offset order)
    by the submitter thread the first time the schedule passes their
    offset — e.g. ``(duration/2, lambda: frontdoor.swap(...))`` for the
    mid-load hot swap. Their return values are reported under
    ``action_results``.

    log: when a list, every admitted request appends ``(tenant, ids,
    ticket)`` in submit order (callers check the responses afterwards;
    an action sees ``len(log)`` as the count submitted before it).
    """
    rng = np.random.default_rng(cfg.seed)
    tenants = list(tenants or frontdoor.registry.tenants)
    weights = np.asarray(tenant_weights if tenant_weights is not None
                         else [1.0] * len(tenants), np.float64)
    weights = weights / weights.sum()
    offsets = arrival_times(cfg, rng)
    sizes = rng.choice(np.asarray(cfg.sizes, np.int64), size=offsets.size)
    which = rng.choice(len(tenants), size=offsets.size, p=weights)
    actions = sorted(actions, key=lambda a: a[0])
    action_results = []

    tickets = []            # (ticket, t_scheduled)
    shed = 0
    next_action = 0
    t0 = clock.now()
    for i in range(offsets.size):
        target = t0 + offsets[i]
        while next_action < len(actions) \
                and offsets[i] >= actions[next_action][0]:
            action_results.append(actions[next_action][1]())
            next_action += 1
        delay = target - clock.now()
        if delay > 0:
            time.sleep(delay)
        tenant = tenants[which[i]]
        n_users = max(1, frontdoor.registry.tenant(tenant).n_users)
        ids = zipf_ids(rng, int(sizes[i]), n_users, cfg.zipf_a)
        try:
            tickets.append(frontdoor.submit(ids, tenant=tenant,
                                            deadline_ms=cfg.deadline_ms))
        except RequestShed:
            shed += 1
            continue
        if log is not None:
            log.append((tenant, ids, tickets[-1]))
    while next_action < len(actions):        # actions past the last arrival
        action_results.append(actions[next_action][1]())
        next_action += 1
    submit_span = clock.now() - t0

    ok = timeouts = failed = 0
    for ticket in tickets:
        try:
            ticket.result(timeout=result_timeout)
            ok += 1
        except DeadlineExceeded:
            timeouts += 1
        except Exception:
            failed += 1
    span = clock.now() - t0
    offered = offsets.size / cfg.duration_s
    return {
        "offered": int(offsets.size),
        "offered_qps": round(offered, 1),
        "submitted": len(tickets),
        "responses": ok,
        "shed": shed,
        "timeouts": timeouts,
        "failed": failed,
        "sustained_qps": round(ok / span, 1) if span > 0 else float("nan"),
        "submit_span_s": round(submit_span, 3),
        "span_s": round(span, 3),
        "action_results": action_results,
    }

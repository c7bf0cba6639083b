"""Interaction-replay: drive a live deployment from a drift stream
(port of ``repro.stream.replay``, with the reference's report keys).

The loop the CLI, the example and the stream benchmark all share:

    for each step:   append -> cold-assign -> (periodic) refresh + tune
                     -> export artifact -> delta -> apply -> swap

Every publication goes through the delta path (``new.delta(prev)`` /
``prev.apply_delta(delta)``) even though updater and session share a
process here — the replay is a rehearsal of the real deployment, where
the updater and the serving fleet are different machines and the delta
bundle is what crosses the wire. The session is only ever touched via
``swap`` (arch rule). Every time is a host clock read after the step's
work came back to the host (cold-assign and refresh labels, tuned
codebooks) or after the device finished it (a swap ends in a
synchronize).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.obs import clock
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.telemetry import StreamTelemetry

__all__ = ["ReplayConfig", "replay"]


@dataclasses.dataclass
class ReplayConfig:
    refresh_every: int = 2      # refresh/tune cadence, in stream steps
    tune_steps: int = 60        # BPR fine-tune steps per refresh
    requests_per_step: int = 0  # serve traffic between steps (smoke)
    request_batch: int = 8
    seed: int = 0


def replay(updater, steps: Sequence, session=None,
           cfg: Optional[ReplayConfig] = None,
           telemetry: Optional[StreamTelemetry] = None,
           log: Optional[Callable[[str], None]] = None) -> dict:
    """Replay ``steps`` (objects with n_new_users/n_new_items/edge_u/
    edge_v — ``repro_torch.data.DriftStream.steps``) into ``updater``,
    hot-swapping ``session`` (may be None: update-only) after every
    event batch. Returns the replay report (latencies + telemetry)."""
    cfg = cfg or ReplayConfig()
    steps = list(steps)
    tele = telemetry or (session.telemetry if session is not None
                         else StreamTelemetry())
    rng = np.random.default_rng(cfg.seed)
    prev_art = updater.export_artifact()
    assign_ms, refresh_ms, tune_ms, delta_bytes = [], [], [], []
    tracer = get_tracer()
    for t, step in enumerate(steps):
        step_span = tracer.trace("stream_step", step=t)
        with tracer.span("apply_events", parent=step_span):
            out = updater.apply_events(step.n_new_users, step.n_new_items,
                                       step.edge_u, step.edge_v)
        info, stats = out["append"], out["assign"]
        tele.bump("appends")
        tele.bump("new_edges", info.n_new_edges)
        tele.bump("cold_users", stats.n_new_users)
        tele.bump("cold_items", stats.n_new_items)
        assign_ms.append(stats.ms)
        line = (f"step {t}: +{stats.n_new_users}u/+{stats.n_new_items}i "
                f"+{info.n_new_edges}e cold-assign {stats.ms:.1f}ms "
                f"(adopted {stats.adopted_users}u/{stats.adopted_items}i)")
        if cfg.refresh_every and (t + 1) % cfg.refresh_every == 0:
            with tracer.span("refresh", parent=step_span):
                rstats = updater.refresh()
            tele.bump("refreshes")
            tele.record_churn((rstats.churn_users + rstats.churn_items) / 2)
            refresh_ms.append(rstats.ms)
            t0 = clock.now()
            if cfg.tune_steps:
                with tracer.span("tune", parent=step_span,
                                 steps=cfg.tune_steps):
                    updater.tune(cfg.tune_steps)
            tune_ms.append(clock.ms_between(t0, clock.now()))
            line += (f" | refresh {rstats.iters} sweeps "
                     f"churn {rstats.churn_users:.2f}u/"
                     f"{rstats.churn_items:.2f}i {rstats.ms:.0f}ms "
                     f"tune {tune_ms[-1]:.0f}ms")
        with tracer.span("export_delta", parent=step_span):
            art = updater.export_artifact()
            delta = art.delta(prev_art)
            published = prev_art.apply_delta(delta)  # what the wire delivers
        delta_bytes.append(delta.nbytes())
        if session is not None:
            with tracer.span("swap", parent=step_span):
                swap = session.swap(published)
            if tele is not session.telemetry:
                # an explicitly supplied telemetry must still see the
                # swaps the session recorded into its own counters
                tele.swap.record(swap["ms"])
                if swap["capacity_bumped"]:
                    tele.bump("capacity_bumps")
            line += (f" | delta {delta.nbytes() // 1024}KB "
                     f"swap {swap['ms']:.1f}ms"
                     f"{' (capacity bump)' if swap['capacity_bumped'] else ''}")
            for _ in range(cfg.requests_per_step):
                ids = rng.integers(0, published.model["n_users"],
                                   cfg.request_batch)
                session(ids)
        prev_art = published
        step_span.end()
        if log:
            log(line)
    return {
        "steps": len(steps),
        # the first cold-assign pays one-time set-up (in the reference
        # an XLA compile; here the first launches); later calls are the
        # steady-state cost, reported apart
        "cold_assign_first_ms": round(float(assign_ms[0]), 3)
        if assign_ms else float("nan"),
        "cold_assign_warm_p50_ms": round(float(np.median(assign_ms[1:])), 3)
        if len(assign_ms) > 1 else float("nan"),
        "cold_assign_p50_ms": round(float(np.median(assign_ms)), 3)
        if assign_ms else float("nan"),
        "cold_assign_total_ms": round(float(np.sum(assign_ms)), 1),
        "refresh_total_ms": round(float(np.sum(refresh_ms)), 1),
        "tune_total_ms": round(float(np.sum(tune_ms)), 1),
        # per re-grouping event (solve + SCU, fine-tune)
        "refresh_events_ms": [round(a + b, 1)
                              for a, b in zip(refresh_ms, tune_ms)],
        "delta_bytes_mean": int(np.mean(delta_bytes)) if delta_bytes else 0,
        "telemetry": tele.summary(),
        "final_artifact": prev_art,
    }

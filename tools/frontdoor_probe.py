#!/usr/bin/env python3
"""Where the serving front end's time goes on one NVIDIA GPU, at the
full width of amazonbook (52,643 users, 91,599 items, d 64).

    python3 tools/frontdoor_probe.py [--rates 120,600] [--duration 4]

(``--dataset synth_xs --device cpu --rates 10,40`` rehearses it on the
CPU.)

Trains a base and a v2 as the load bench does
(``repro_torch.launch.load_bench._two_versions``: BACO at ratio 0.25,
600 steps, then 40 more shipped as a verified delta), then:

1. **Swap anatomy, idle.** The load bench's Frontdoor
   (``load_bench.frontdoor``: ``web`` alone on a capacity-padded fp32
   session, ``mobile`` and ``beta`` on one int8 session) with no
   traffic: ``web`` swapped base -> v2 -> base -> v2, each pause
   (the first swap of a session also allocates its pinned staging
   buffers); then the host parts of one swap timed alone: the
   artifact's statics rebuilt on the host (``_host_state``) and padded
   to the rungs (``pad_to_capacity``).
2. **Closed loop.** One thread calling each session's dispatcher at
   B 1 and 8, 20 calls each: the per-batch floor of the batcher.
3. **Open loop with the tracer on**, per rate, on fresh tenants
   (``load_bench.run``, ``web`` swapping halfway): from the spans,
   the batches and requests per batch, the device span (a dispatcher
   call: upload, kernels, synchronize, copy back) by tenant, the
   batcher's busy share (batch spans over the run), and the requests
   whose queue wait overlaps the swap's hold of the dispatch lock (count,
   their e2e) against the e2e p99 of the rest. Tracing costs a few
   microseconds a span, seven spans a request.

Prints one ``frontdoor_probe`` JSON line and the card's name and power
limit. Times are host clock readings (``repro_torch.obs.clock``) around
work that ends in a synchronize.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, float), q)) if xs else None


def swap_anatomy(base, v2, device) -> dict:
    from repro_torch.launch import load_bench as LB
    from repro_torch.obs import clock
    from repro_torch.serve.session import _host_state, pad_to_capacity
    fd = LB.frontdoor(base, device=device)
    warm = fd.state_allocations
    pauses = [fd.swap("web", art)["pause_ms"] for art in (v2, base, v2)]
    assert fd.state_allocations == warm, "an idle swap allocated"
    sess = fd.registry.session("web")
    t0 = clock.now()
    params, statics = _host_state(base)
    t1 = clock.now()
    mcfg = dataclasses.replace(base.mcfg(),
                               lookup_backend=sess.mcfg.lookup_backend)
    pad_to_capacity(params, statics, mcfg, sess.stats()["capacity"])
    t2 = clock.now()
    return {"pause_ms": pauses,
            "host_state_ms": clock.ms_between(t0, t1),
            "pad_ms": clock.ms_between(t1, t2)}


def closed_loop(base, device) -> dict:
    from repro_torch.launch import load_bench as LB
    from repro_torch.obs import clock
    fd = LB.frontdoor(base, device=device)
    out = {}
    for tenant in ("web", "mobile"):
        disp = fd.registry.dispatcher(tenant)
        for b in (1, 8):
            ids = list(range(b))
            ms = []
            for _ in range(20):
                t0 = clock.now()
                disp(ids)
                ms.append(clock.ms_between(t0, clock.now()))
            out[f"{tenant}_b{b}_p50_ms"] = statistics.median(ms)
    return out


def traced_run(base, v2, qps, duration, device) -> dict:
    from repro_torch.launch import load_bench as LB
    from repro_torch.obs.trace import configure
    tracer = configure(enabled=True, sample_rate=1.0, max_spans=500_000)
    tracer.drain()
    fd = LB.frontdoor(base, device=device)
    rec = LB.run(fd, v2, qps=qps, duration=duration, seed=0)
    spans = tracer.drain()
    configure(enabled=False)
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.name == "request"]
    tenant_of = {s.span_id: s.attrs.get("tenant") for s in roots}
    swap = next(s for s in spans if s.name == "frontdoor_swap")
    drain = next(s for s in spans if s.name == "drain")
    hold = (drain.t_end, swap.t_end)
    batches = {}
    for s in spans:
        if s.name == "batch":
            batches.setdefault(s.t_start, s)
    devices = {}
    for s in spans:
        if s.name == "device":
            root = by_id[by_id[by_id[s.parent_id].parent_id].parent_id]
            devices.setdefault(s.t_start, (tenant_of[root.span_id],
                                           (s.t_end - s.t_start) * 1e3))
    queued = {s.parent_id: s for s in spans if s.name == "queue"}
    waited, rest = [], []
    for r in roots:
        if r.attrs.get("outcome") != "ok":
            continue
        e2e = (r.t_end - r.t_start) * 1e3
        q = queued[r.span_id]
        (waited if q.t_start < hold[1] and q.t_end > hold[0]
         else rest).append(e2e)
    n_req = [b.attrs["n_requests"] for b in batches.values()]
    busy = sum(b.t_end - b.t_start for b in batches.values())
    span = max(r.t_end for r in roots) - min(r.t_start for r in roots)
    dev = {}
    for tenant, ms in devices.values():
        dev.setdefault("web" if tenant == "web" else "int8", []).append(ms)
    return {
        "record": {k: rec[k] for k in (
            "offered_qps", "sustained_qps", "e2e_p50_ms", "e2e_p99_ms",
            "queue_delay_p50_ms", "queue_delay_p99_ms", "batch_fill_mean",
            "batches", "coalesced", "cache_hits", "swap_pause_ms",
            "swap_drain_ms", "state_allocations_under_load")},
        "batches": len(batches),
        "requests_per_batch_mean": statistics.mean(n_req),
        "requests_per_batch_max": max(n_req),
        "device_ms": {k: {"n": len(v), "p50": pct(v, 50), "p99": pct(v, 99)}
                      for k, v in dev.items()},
        "batcher_busy_share": busy / span,
        "swap_hold_ms": (hold[1] - hold[0]) * 1e3,
        "waited_on_swap": {"n": len(waited), "e2e_p50_ms": pct(waited, 50),
                           "e2e_max_ms": max(waited) if waited else None},
        "others_e2e_p99_ms": pct(rest, 99),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rates", default="120,600")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--dataset", default="amazonbook")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.launch import load_bench as LB
    dev = args.device
    base, v2 = LB._two_versions(args.dataset, 64, 600, 40, dev)
    out = {"dataset": args.dataset, "device": dev,
           "swap_idle": swap_anatomy(base, v2, dev),
           "closed_loop": closed_loop(base, dev), "rates": {}}
    for qps in (float(r) for r in args.rates.split(",")):
        out["rates"][f"{qps:g}"] = traced_run(base, v2, qps, args.duration,
                                              dev)
    print(json.dumps({"frontdoor_probe": out}))
    if dev == "cpu":
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())

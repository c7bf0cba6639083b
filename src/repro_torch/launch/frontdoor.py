"""Frontdoor launcher for the port: drive the async serving front end
under load (``python -m repro_torch.launch.frontdoor``; port of
``repro.launch.frontdoor``).

Obtains a CompressedArtifact like ``repro_torch.launch.serve`` (loads
``--artifact`` when published there, else builds one), attaches
``--tenants`` logical tenants that SHARE its device session, then drives
the stack with open-loop traffic (Poisson arrivals at ``--qps``, Zipf
user popularity, mixed request sizes) and reports sustained QPS,
e2e/queue-delay p50/p99, batch-fill ratio, shed/timeout counts and the
device state allocated under load.

``--swap-mid-load`` instead trains the base on ``--dataset``, publishes
a second version (the base fine-tuned for ``--swap-extra-steps`` more
BPR steps, shipped as a verified delta) and hot-swaps tenant 0 onto it
halfway through the run — the drain-then-swap pause is measured under
fire, and the session allocates no device state for it under its
capacity ladder.

Runs on the CUDA device by default (``--device cpu`` runs the kernels'
plain versions on the CPU). For the three-tenant record, run
``python -m repro_torch.launch.load_bench --json``.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="gowalla_s")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--artifact", default=None,
                    help="artifact dir: load if published, else build "
                         "once and export here")
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--scorer", default="auto")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--tenants", type=int, default=2,
                    help="logical tenants sharing the artifact's session")
    ap.add_argument("--buckets", default="1,8,64",
                    help="bucket ladder (comma-separated)")
    ap.add_argument("--qps", type=float, default=150.0)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--burst-factor", type=float, default=2.0,
                    help="arrival-rate multiplier during burst windows "
                         "(1 = pure Poisson)")
    ap.add_argument("--flush-ms", type=float, default=2.0)
    ap.add_argument("--queue-size", type=int, default=512)
    ap.add_argument("--policy", default="shed", choices=["shed", "block"])
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline budget (expired requests "
                         "are rejected unscored)")
    ap.add_argument("--cache", type=int, default=2048,
                    help="hot-user cache entries (0 disables)")
    ap.add_argument("--swap-mid-load", action="store_true",
                    help="hot-swap tenant 0 to a fine-tuned artifact "
                         "version halfway through the run")
    ap.add_argument("--swap-extra-steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # fail fast on typo'd names, before any training happens
    from repro_torch.embedding import normalize_backend
    from repro_torch.serve.session import normalize_scorer
    try:
        backend = normalize_backend(args.backend)
        scorer = normalize_scorer(args.scorer)
    except (KeyError, ValueError) as e:
        ap.error(str(e.args[0] if e.args else e))

    from repro_torch.frontdoor import (Frontdoor, FrontdoorConfig,
                                       TrafficConfig, run_open_loop)

    v2 = None
    if args.swap_mid_load:
        # one training run yields both versions: export the base, keep
        # fine-tuning, and ship the update as a verified artifact delta
        # (v2 has the base's shapes, so the swap fits its rungs)
        from repro_torch.core import ClusterEngine
        from repro_torch.data import paperlike_dataset
        from repro_torch.launch.load_bench import ship_v2
        from repro_torch.training import TrainConfig, Trainer
        _, _, _, train, _ = paperlike_dataset(args.dataset, seed=0)
        sketch = ClusterEngine(device=args.device).build(
            train, d=args.dim, ratio=0.25)
        tr = Trainer(train, sketch,
                     TrainConfig(dim=args.dim, steps=args.steps,
                                 batch_size=2048, lr=5e-3,
                                 lookup_backend=backend),
                     device=args.device)
        tr.run(log_every=0)
        art = tr.export()
        v2 = ship_v2(tr, art, args.swap_extra_steps)
        print(f"[frontdoor] v2 published: delta vs base, "
              f"id {v2.content_id()[:12]}")
    else:
        from repro_torch.launch.serve import _get_artifact
        art = _get_artifact(args)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    fd = Frontdoor(FrontdoorConfig(
        queue_size=args.queue_size, policy=args.policy,
        flush_ms=args.flush_ms, default_deadline_ms=args.deadline_ms,
        cache_entries=args.cache, k=args.k, buckets=buckets,
        backend=backend, scorer=scorer, capacity="auto",
        device=args.device))
    tenants = [f"tenant{i}" for i in range(max(args.tenants, 1))]
    actions = []
    if args.swap_mid_load and len(tenants) > 1:
        # tenant0 must be its version's SOLE owner for the in-place
        # (allocation-free) swap path; the rest share a quantized copy
        # of the same model — session pooling still on display, and the
        # int8 tables shrink the resident footprint of the shared pool.
        fd.attach(tenants[0], art)
        shared = art.quantize()
        for name in tenants[1:]:
            fd.attach(name, shared, capacity=None)
    else:
        for name in tenants:
            fd.attach(name, art)                  # all share one session
    allocs_warm = fd.state_allocations
    print(f"[frontdoor] {len(tenants)} tenants over "
          f"{fd.registry.n_sessions} device session(s) on {fd.device}, "
          f"ladder {buckets} warmed ({allocs_warm} state allocations)")

    if v2 is not None:
        actions = [(args.duration / 2,
                    lambda: fd.swap(tenants[0], v2))]

    with fd:
        report = run_open_loop(
            fd, TrafficConfig(qps=args.qps, duration_s=args.duration,
                              burst_factor=args.burst_factor,
                              deadline_ms=args.deadline_ms,
                              seed=args.seed),
            tenants=tenants, actions=actions)
    st = fd.stats()
    load_allocs = fd.state_allocations - allocs_warm
    print(f"[frontdoor] offered {report['offered_qps']} qps -> sustained "
          f"{report['sustained_qps']} qps over {report['span_s']}s; "
          f"e2e p50={st['e2e_p50_ms']}ms p99={st['e2e_p99_ms']}ms "
          f"queue p99={st['queue_delay_p99_ms']}ms")
    print(f"[frontdoor] {st['batches']} batches fill={st['batch_fill_mean']}"
          f" buckets={st['bucket_counts']}; shed={report['shed']} "
          f"timeouts={report['timeouts']} cache_hits={st['cache_hits']}")
    if args.swap_mid_load:
        swap = report["action_results"][0]
        print(f"[frontdoor] mid-load swap: mode={swap['mode']} "
              f"pause={swap['pause_ms']}ms (drain {swap['drain_ms']}ms)")
    print(f"[frontdoor] state allocations under load: {load_allocs} "
          f"(must be 0 in capacity)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

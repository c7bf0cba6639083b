"""Load bench for the port: the serving front end under open-loop fire
(``python -m repro_torch.launch.load_bench``; the scenario of the
reference's ``benchmarks/load_bench.py``).

Closed-loop serving numbers measure the server at its own pace; this
bench submits Poisson/bursty arrivals at scheduled wall-clock times
whether or not earlier requests finished, so queue delay, admission
sheds and tail latency are real numbers.

Scenario (one run, everything measured together):

  * one training run publishes TWO artifact versions — the base, and a
    fine-tune shipped as a verified delta (``base.apply_delta(
    v2.delta(base))``: the same shapes, so the mid-load swap fits the
    base's capacity rungs);
  * three tenants over two device sessions: ``web`` solely owns the
    base (capacity ladder — hot-swappable in place), ``mobile`` +
    ``beta`` SHARE one session over the int8-quantized copy;
  * every session scores with the fused top-k kernel (the reference's
    bench serves its default dense scorer; on the H100 the dense
    scorer spends most of a request sorting every item);
  * open-loop mixed traffic (Zipf users, mixed sizes, 2x bursts, tenant
    weights 0.5 / 0.3 / 0.2) with a hot-user cache in front;
  * halfway through, ``web`` hot-swaps to v2 UNDER LOAD — the
    drain+swap pause is measured from inside the traffic, and the
    device state allocated across every session must not move.

The record (bench ``server``) goes to the port's results store through
``repro_torch.results.BenchRun``, with the reference's config dict and
headline metrics (:func:`server_metrics`); ``--json`` prints it as one
JSON line: the reference's keys, with ``state_allocations_warm`` /
``state_allocations_under_load`` in place of its compile counts, plus
``allocator_segments_under_load`` (CUDA caching-allocator segments
allocated during the run; null on the CPU). Runs on the CUDA device by
default (``--device cpu`` runs the kernels' plain versions on the CPU).
"""
from __future__ import annotations

import sys

from repro_torch.results import BenchRun, higher, lower

BUCKETS = (1, 8, 64)
SCORER = "fused"
TENANTS = ("web", "mobile", "beta")
TENANT_WEIGHTS = (0.5, 0.3, 0.2)


def _two_versions(dataset: str, dim: int, steps: int, extra_steps: int,
                  device="cuda"):
    """Train once; return (base artifact, delta-shipped v2)."""
    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import TrainConfig, Trainer
    _, _, _, train, _ = paperlike_dataset(dataset, seed=0)
    sketch = ClusterEngine(device=device).build(train, d=dim, ratio=0.25)
    tr = Trainer(train, sketch, TrainConfig(dim=dim, steps=steps,
                                            batch_size=1024, lr=5e-3),
                 device=device)
    tr.run(log_every=0)
    base = tr.export()
    return base, ship_v2(tr, base, extra_steps)


def ship_v2(trainer, base, extra_steps: int):
    """Fine-tune ``trainer`` ``extra_steps`` more steps past the export
    ``base`` and publish the result as a verified delta on it."""
    trainer.run(steps=trainer.step + extra_steps, log_every=0)
    return base.apply_delta(trainer.export().delta(base))


def frontdoor(base, flush_ms: float = 2.0, queue_size: int = 256,
              cache_entries: int = 1024, deadline_ms=None,
              device="cuda"):
    """The bench's Frontdoor: ``web`` alone on the base with a capacity
    ladder; ``mobile`` and ``beta`` on one int8 session. Every session
    is warmed."""
    from repro_torch.frontdoor import Frontdoor, FrontdoorConfig
    fd = Frontdoor(FrontdoorConfig(
        queue_size=queue_size, policy="shed", flush_ms=flush_ms,
        default_deadline_ms=deadline_ms, cache_entries=cache_entries,
        k=20, buckets=BUCKETS, scorer=SCORER, device=device))
    fd.attach("web", base, capacity="auto")      # sole owner: swappable
    shared = base.quantize()
    fd.attach("mobile", shared)                  # one int8 session,
    fd.attach("beta", shared)                    # two tenants
    return fd


def _segments(fd) -> int:
    import torch
    return torch.cuda.memory_stats(fd.device)["segment.all.allocated"]


def run(fd, v2, qps: float = 120.0, duration: float = 4.0,
        deadline_ms=None, seed: int = 0, log=None) -> dict:
    """Drive the warmed ``fd`` open-loop for ``duration`` seconds with
    ``web`` swapping to ``v2`` halfway; returns the record.

    log: when a dict, it receives ``requests`` (every admitted request
    as ``(tenant, ids, ticket)``, in submit order) and ``swap`` (the obs
    clock readings around the swap call, and how many requests were
    submitted before it), for a caller that checks the responses.
    """
    from repro_torch.frontdoor import TrafficConfig, run_open_loop
    from repro_torch.obs import clock
    requests = [] if log is not None else None
    window = {}

    def swap():
        window["t_start"] = clock.now()
        window["submitted_before"] = len(requests or ())
        out = fd.swap("web", v2)
        window["t_end"] = clock.now()
        return out

    cuda = fd.device.type == "cuda"
    warm = fd.state_allocations
    segments = _segments(fd) if cuda else None
    with fd:
        report = run_open_loop(
            fd,
            TrafficConfig(qps=qps, duration_s=duration, burst_factor=2.0,
                          deadline_ms=deadline_ms, seed=seed),
            tenants=list(TENANTS), tenant_weights=list(TENANT_WEIGHTS),
            actions=[(duration / 2, swap)], log=requests)
    if log is not None:
        log["requests"] = requests
        log["swap"] = window
    st = fd.stats()
    swap_out = report["action_results"][0]
    record = {
        "bench": "server",
        "platform": fd.device.type,
        "buckets": list(BUCKETS),
        "tenants": len(TENANTS),
        "sessions": st["registry"]["sessions"],
        "qps": qps, "duration_s": duration,
        "offered": report["offered"],
        "offered_qps": report["offered_qps"],
        "responses": report["responses"],
        "sustained_qps": report["sustained_qps"],
        "shed": report["shed"],
        "timeouts": report["timeouts"],
        "failed": report["failed"],
        "e2e_p50_ms": st["e2e_p50_ms"],
        "e2e_p99_ms": st["e2e_p99_ms"],
        "queue_delay_p50_ms": st["queue_delay_p50_ms"],
        "queue_delay_p99_ms": st["queue_delay_p99_ms"],
        "batch_fill_mean": st["batch_fill_mean"],
        "batches": st["batches"],
        "coalesced": st["coalesced"],
        "bucket_counts": {str(k): v
                          for k, v in st["bucket_counts"].items()},
        "cache_hits": st["cache_hits"],
        "swap_mode": swap_out["mode"],
        "swap_pause_ms": swap_out["pause_ms"],
        "swap_drain_ms": swap_out["drain_ms"],
        "state_allocations_warm": warm,
        "state_allocations_under_load": fd.state_allocations - warm,
        "allocator_segments_under_load": (_segments(fd) - segments
                                          if cuda else None),
    }
    if record["swap_mode"] != "swapped":
        record["warning"] = (f"expected the in-place swap path, got "
                             f"{record['swap_mode']}")
    return record


def bench(dataset: str = "beauty_s", dim: int = 32, steps: int = 60,
          extra_steps: int = 24, qps: float = 120.0, duration: float = 4.0,
          flush_ms: float = 2.0, queue_size: int = 256,
          cache_entries: int = 1024, deadline_ms=None, seed: int = 0,
          device="cuda") -> dict:
    """Train both versions, build the Frontdoor, run; -> the record."""
    base, v2 = _two_versions(dataset, dim, steps, extra_steps, device)
    fd = frontdoor(base, flush_ms=flush_ms, queue_size=queue_size,
                   cache_entries=cache_entries, deadline_ms=deadline_ms,
                   device=device)
    record = run(fd, v2, qps=qps, duration=duration,
                 deadline_ms=deadline_ms, seed=seed)
    record.update(dataset=dataset, dim=dim)
    return record


def server_metrics(record) -> dict:
    """Declared-direction headline metrics of the open-loop record: the
    reference's, plus ``state_allocations_under_load`` where the port's
    record carries it in place of ``compiles_under_load``."""
    out = {}
    for key, make in (("sustained_qps", higher), ("e2e_p50_ms", lower),
                      ("e2e_p99_ms", lower),
                      ("queue_delay_p50_ms", lower),
                      ("queue_delay_p99_ms", lower),
                      ("batch_fill_mean", higher),
                      ("swap_pause_ms", lower),
                      ("swap_drain_ms", lower),
                      ("compiles_under_load", lower),
                      ("state_allocations_under_load", lower),
                      ("shed", lower), ("failed", lower)):
        v = record.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = make(v)
    return out


def main(argv=None):
    run_ = BenchRun("server", description=__doc__)
    run_.add_argument("--dataset", default="beauty_s")
    run_.add_argument("--dim", type=int, default=32)
    run_.add_argument("--steps", type=int, default=60)
    run_.add_argument("--extra-steps", type=int, default=24)
    run_.add_argument("--qps", type=float, default=120.0)
    run_.add_argument("--duration", type=float, default=4.0)
    run_.add_argument("--flush-ms", type=float, default=2.0)
    run_.add_argument("--queue-size", type=int, default=256)
    run_.add_argument("--cache", type=int, default=1024)
    run_.add_argument("--deadline-ms", type=float, default=None)
    run_.add_argument("--seed", type=int, default=0)
    args = run_.parse(argv)
    config = {"dataset": args.dataset, "dim": args.dim,
              "steps": args.steps, "extra_steps": args.extra_steps,
              "qps": args.qps, "duration_s": args.duration,
              "flush_ms": args.flush_ms, "queue_size": args.queue_size,
              "cache_entries": args.cache,
              "deadline_ms": args.deadline_ms, "seed": args.seed,
              "buckets": list(BUCKETS)}
    hit = run_.cached(config)
    if hit is not None:
        run_.replay(hit)
        return 0
    with run_.profile("open_loop"):
        record = bench(dataset=args.dataset, dim=args.dim, steps=args.steps,
                       extra_steps=args.extra_steps, qps=args.qps,
                       duration=args.duration, flush_ms=args.flush_ms,
                       queue_size=args.queue_size, cache_entries=args.cache,
                       deadline_ms=args.deadline_ms, seed=args.seed,
                       device=run_.device)
    if not args.json:
        for k, v in record.items():
            print(f"{k}: {v}")
    run_.emit(config, server_metrics(record), record)
    if record["state_allocations_under_load"]:
        print(f"WARNING: {record['state_allocations_under_load']} device "
              f"state allocations under load (expected 0)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

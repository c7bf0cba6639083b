"""Serving bench of the port: p50/p99 per (lookup backend x scorer x
batch bucket) through the ``repro_torch.serve`` stack (``python -m
repro_torch.launch.serve_bench``; a port of ``benchmarks/serve_bench.py``,
bench ``serve_session``).

Trains one small compressed model, then for every registered lookup
backend (plus auto-selection) and both scorers ("dense": every item
scored and sorted; "fused": the fused_topk kernel) builds a
``RecsysSession`` behind a ``BatchDispatcher`` and times requests at
each rung of the bucket ladder, host clock around each request (the
session synchronizes before it returns). PyTorch runs eagerly, so the
reference's ``compiles`` column becomes ``state_allocations``: the
params and statics tensors the session allocated over its life
(``RecsysSession.state_allocations``), which no request may move. A
backend or scorer that cannot serve becomes an ``error`` row.

    python -m repro_torch.launch.serve_bench --dataset amazonbook --dim 64
    python -m repro_torch.launch.serve_bench --device cpu --json --no-store

Runs on the CUDA device by default; the payload:

    {"bench": "serve_session", "platform": ..., "records":
      [{"backend", "scorer", "bucket", "p50_ms", "p99_ms",
        "state_allocations"}, ...]}
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.results import BenchRun, lower

BUCKETS = (1, 8, 64)
SCORERS = ("dense", "fused")


def _trained(dataset: str, dim: int, steps: int, device):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import TrainConfig, Trainer
    _, _, _, train, _ = paperlike_dataset(dataset, seed=0)
    sketch = ClusterEngine(device=device).build(train, d=dim, ratio=0.25)
    tr = Trainer(train, sketch, TrainConfig(dim=dim, steps=steps,
                                            batch_size=1024, lr=5e-3),
                 device=device)
    tr.run(log_every=0)
    return tr


def bench(dataset: str = "beauty_s", dim: int = 32, steps: int = 40,
          n_requests: int = 20, buckets=BUCKETS, device="cuda"):
    """-> list of JSON-able {backend, scorer, bucket, p50_ms, p99_ms,
    state_allocations}."""
    from repro_torch.device import resolve_device
    from repro_torch.embedding import available_backends
    from repro_torch.serve import BatchDispatcher, RecsysSession
    dev = resolve_device(device)
    tr = _trained(dataset, dim, steps, dev)
    rng = np.random.default_rng(0)
    records = []
    for name in ("auto",) + tuple(available_backends()):
        backend = None if name == "auto" else name
        for scorer in SCORERS:
            try:
                session = RecsysSession(tr.params, tr.statics, tr.mcfg,
                                        k=20, backend=backend,
                                        scorer=scorer, device=dev)
                disp = BatchDispatcher(session, buckets=buckets)
                disp.warmup()
            except Exception as exc:  # the reference's error row
                records.append({"backend": name, "scorer": scorer,
                                "error": f"{type(exc).__name__}: "
                                         f"{exc}"[:200]})
                continue
            for bucket in buckets:
                lat = []
                for _ in range(n_requests):
                    ids = rng.integers(0, tr.graph.n_users, bucket)
                    t0 = clock.now()
                    disp(ids)
                    lat.append(clock.ms_between(t0, clock.now()))
                lat = np.asarray(lat)
                records.append({
                    "backend": name, "scorer": scorer,
                    "bucket": int(bucket), "n_requests": n_requests,
                    "p50_ms": round(float(np.percentile(lat, 50)), 3),
                    "p99_ms": round(float(np.percentile(lat, 99)), 3),
                    "state_allocations": session.state_allocations,
                })
    return records


def session_metrics(records) -> dict:
    """Declared-direction headline metrics over the per-bucket rows:
    the reference's, with ``max_state_allocations`` in place of
    ``max_compiles`` for rows that count allocations."""
    rows = [r for r in records if "p50_ms" in r]
    out = {"serve_errors": lower(len([r for r in records
                                      if "error" in r]))}
    if rows:
        out["best_p50_ms"] = lower(min(r["p50_ms"] for r in rows))
        out["best_p99_ms"] = lower(min(r["p99_ms"] for r in rows))
        key = ("state_allocations"
               if any("state_allocations" in r for r in rows)
               else "compiles")
        out[f"max_{key}"] = lower(max(r.get(key, 0) for r in rows))
    return out


def main(argv=None):
    run = BenchRun("serve_session", description=__doc__)
    run.add_argument("--dataset", default="beauty_s")
    run.add_argument("--dim", type=int, default=32)
    run.add_argument("--steps", type=int, default=40)
    run.add_argument("--n-requests", type=int, default=20)
    args = run.parse(argv)
    config = {"dataset": args.dataset, "dim": args.dim,
              "steps": args.steps, "n_requests": args.n_requests,
              "buckets": list(BUCKETS)}
    hit = run.cached(config)
    if hit is not None:
        run.replay(hit)
        if not args.json:
            for r in hit.get("payload", {}).get("records", []):
                print(r)
        return 0
    dev = run.device
    with run.profile("serve_sweep"):
        records = bench(dataset=args.dataset, dim=args.dim,
                        steps=args.steps, n_requests=args.n_requests,
                        device=dev)
    record = {"bench": "serve_session", "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "buckets": list(BUCKETS), "scorers": list(SCORERS),
              "dataset": args.dataset, "dim": args.dim,
              "records": records}
    if not args.json:
        for r in records:
            print(r)
    run.emit(config, session_metrics(records), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

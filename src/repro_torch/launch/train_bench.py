"""Training-pipeline bench of the port: steps/s per (trainer backend x
chunk size) against the seed host loop (``python -m
repro_torch.launch.train_bench``; a port of ``benchmarks/train_bench.py``,
bench ``train_pipeline``).

Builds one compressed model (BACO at ratio 0.25), then times each
registered trainer backend. The baseline row is ``host_seed``, the
frozen seed step (``index_add_`` propagation, six readout gathers) in
the host loop; ``host`` is the same loop over the current step (the
weighted CSR gather-sum kernel on CUDA); ``fused`` runs chunks of steps
with the device sampler and one host copy a chunk; ``fused_sharded`` is
``fused`` data parallel over the ``torch.distributed`` world (a world of
1 unless the bench runs under ``torchrun``). Rounds are
interleaved across backends and medianed, so drift hits every backend
equally; each round ends in a device synchronize. A backend that cannot
run becomes an ``error`` row.

    python -m repro_torch.launch.train_bench --dataset amazonbook --dim 64 --batch 2048
    python -m repro_torch.launch.train_bench --device cpu --json --no-store

Runs on the CUDA device by default. Records go to the port's results
store (``repro_torch.results.BenchRun``); the payload is the
reference's:

    {"bench": "train_pipeline", "platform": ..., "records":
      [{"backend", "chunk", "steps_per_s", "speedup_vs_seed",
        "speedup_vs_host"}, ...]}
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.results import BenchRun, higher, lower

CHUNKS = (1, 8, 32)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench(dataset: str = "synth_xs", dim: int = 16, batch: int = 1024,
          steps: int = 32, rounds: int = 5, ratio: float = 0.25,
          chunks=CHUNKS, device="cuda"):
    """-> list of JSON-able {backend, chunk, steps_per_s, speedups}.
    Runs in a ``torch.distributed`` world (``distributed.world``) for the
    ``fused_sharded`` rows."""
    from repro_torch.distributed import world
    with world(device) as dev:
        return _bench(dataset, dim, batch, steps, rounds, ratio, chunks, dev)


def _bench(dataset, dim, batch, steps, rounds, ratio, chunks, dev):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import (TrainConfig, Trainer,
                                      available_trainer_backends)
    _, _, _, train, _ = paperlike_dataset(dataset, seed=0)
    sketch = ClusterEngine(device=dev).build(train, d=dim, ratio=ratio)

    configs = [("host_seed", 1), ("host", 1)]
    for backend in sorted(available_trainer_backends()):
        if backend in ("host", "host_seed"):
            continue
        configs += [(backend, c) for c in chunks]

    trainers, times, errors = {}, {}, {}
    for key in configs:
        backend, chunk = key
        cfg = TrainConfig(dim=dim, steps=10**9, batch_size=batch, lr=5e-3,
                          backend=backend, chunk_size=chunk, seed=0)
        try:
            tr = Trainer(train, sketch, cfg, device=dev)
            warm = max(2 * chunk, 8)
            tr.run(steps=warm, log_every=0)     # first launches, caches
            # one untimed round: a round of `steps` can end in a
            # remainder chunk (steps % chunk)
            tr.run(steps=warm + steps, log_every=0)
            _sync(dev)
        except Exception as exc:    # the reference's error row
            errors[key] = f"{type(exc).__name__}: {exc}"[:200]
            continue
        trainers[key] = [tr, warm + steps]
        times[key] = []
    for _ in range(rounds):         # interleave: drift hits all equally
        for key, state in trainers.items():
            tr, done = state
            t0 = clock.now()
            state[1] = done = done + steps
            tr.run(steps=done, log_every=0)
            _sync(dev)
            times[key].append(steps / (clock.now() - t0))

    med = {k: float(np.median(v)) for k, v in times.items()}
    seed_sps = med.get(("host_seed", 1))
    host_sps = med.get(("host", 1))
    records = []
    for key in configs:
        backend, chunk = key
        if key in errors:
            records.append({"backend": backend, "chunk": int(chunk),
                            "error": errors[key]})
            continue
        rec = {"backend": backend, "chunk": int(chunk),
               "steps_per_s": round(med[key], 2)}
        if seed_sps:
            rec["speedup_vs_seed"] = round(med[key] / seed_sps, 2)
        if host_sps:
            rec["speedup_vs_host"] = round(med[key] / host_sps, 2)
        records.append(rec)
    return records


def pipeline_metrics(records) -> dict:
    """Declared-direction headline metrics over the backend rows (the
    reference's)."""
    rows = [r for r in records if isinstance(r, dict)]
    out = {"records": higher(len(rows)),
           "train_errors": lower(len([r for r in rows if "error" in r]))}
    sp = [r["speedup_vs_seed"] for r in rows
          if isinstance(r.get("speedup_vs_seed"), (int, float))]
    if sp:
        out["best_speedup_vs_seed"] = higher(max(sp))
    sps = [r["steps_per_s"] for r in rows
           if isinstance(r.get("steps_per_s"), (int, float))]
    if sps:
        out["best_steps_per_s"] = higher(max(sps))
    return out


def main(argv=None):
    run = BenchRun("train_pipeline", description=__doc__)
    run.add_argument("--dataset", default="synth_xs")
    run.add_argument("--dim", type=int, default=16)
    run.add_argument("--batch", type=int, default=1024)
    run.add_argument("--steps", type=int, default=32,
                     help="steps per timed round")
    run.add_argument("--rounds", type=int, default=5,
                     help="interleaved timed rounds per backend (median)")
    args = run.parse(argv)
    config = {"dataset": args.dataset, "dim": args.dim,
              "batch": args.batch, "steps": args.steps,
              "rounds": args.rounds, "chunks": list(CHUNKS)}
    hit = run.cached(config)
    if hit is not None:
        run.replay(hit)
        if not args.json:
            for r in hit.get("payload", {}).get("records", []):
                print(r)
        return 0
    dev = run.device
    with run.profile("trainer_sweep"):
        records = bench(dataset=args.dataset, dim=args.dim,
                        batch=args.batch, steps=args.steps,
                        rounds=args.rounds, device=dev)
    record = {"bench": "train_pipeline", "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "n_devices": (torch.cuda.device_count()
                            if dev.type == "cuda" else 1),
              "dataset": args.dataset, "dim": args.dim,
              "batch": args.batch, "steps": args.steps,
              "records": records}
    if not args.json:
        for r in records:
            print(r)
    run.emit(config, pipeline_metrics(records), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

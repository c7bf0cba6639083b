#!/usr/bin/env python3
"""Where the train bench's fused step time goes (on the GPU).

    python3 tools/train_bench_probe.py [--dataset amazonbook] [--rounds 5]

Builds the train bench's model (``launch/train_bench.py``: BACO at ratio
0.25, d 64, batch 2,048, lr 5e-3) and times one fused trainer (chunk 8)
in rounds of 32 steps, each ending in a device synchronize:

  alone        rounds back to back;
  interleaved  each round after one round of each of the bench's other
               backends (host_seed, host, fused at chunks 1 and 32), as
               ``train_bench.bench`` runs them;

then one round of each under ``torch.profiler``: the device's busy ms a
step (kernel time summed by name) beside the wall ms a step; last,
``train_bench.bench`` itself at the same arguments, in the same
process. Prints a ``train_bench_probe`` JSON line and the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="amazonbook")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=32)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.obs import clock
    from repro_torch.training import TrainConfig, Trainer

    if not torch.cuda.is_available():
        print("train_bench_probe: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, _, train, _ = paperlike_dataset(args.dataset, seed=0)
    sketch = ClusterEngine(device="cuda").build(train, d=64, ratio=0.25)

    def make(backend, chunk):
        tr = Trainer(train, sketch, TrainConfig(
            dim=64, steps=10**9, batch_size=2048, lr=5e-3, backend=backend,
            chunk_size=chunk, seed=0), device="cuda")
        tr.run(steps=max(2 * chunk, 8) + args.steps, log_every=0)
        torch.cuda.synchronize()
        return tr

    def one_round(tr) -> float:
        """Wall ms a step of one round."""
        t0 = clock.now()
        tr.run(steps=tr.step + args.steps, log_every=0)
        torch.cuda.synchronize()
        return clock.ms_between(t0, clock.now()) / args.steps

    def profiled(tr, before=()) -> dict:
        for other in before:
            one_round(other)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = one_round(tr)
        busy = 0.0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0.0))
            if (t > 0 and e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.key.startswith(("aten::", "cuda"))):
                busy += t / 1e3
        return {"wall_ms_per_step": wall,
                "device_ms_per_step": busy / args.steps}

    fused = make("fused", 8)
    alone = [one_round(fused) for _ in range(args.rounds)]
    others = [make(b, c) for b, c in (("host_seed", 1), ("host", 1),
                                      ("fused", 1), ("fused", 32))]
    interleaved = []
    for _ in range(args.rounds):
        for other in others:
            one_round(other)
        interleaved.append(one_round(fused))
    out = {"dataset": args.dataset, "steps_per_round": args.steps,
           "alone_ms_per_step": alone,
           "interleaved_ms_per_step": interleaved,
           "alone_median": float(np.median(alone)),
           "interleaved_median": float(np.median(interleaved)),
           "profile_alone": profiled(fused),
           "profile_interleaved": profiled(fused, before=others)}
    del fused, others
    from repro_torch.launch import train_bench
    out["bench_rows"] = train_bench.bench(
        dataset=args.dataset, dim=64, batch=2048, steps=args.steps,
        rounds=args.rounds, device="cuda")
    print(json.dumps({"train_bench_probe": out}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

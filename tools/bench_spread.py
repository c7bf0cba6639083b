#!/usr/bin/env python3
"""Run-to-run spread of every gated bench metric (on the GPU).

    python3 tools/bench_spread.py [--runs 3]

Runs every bench of ``chip_smoke.BENCH_ARGS``
``--runs`` times in one process, interleaved (every bench once, then
every bench again), into one fresh results store, ``--force`` after the
first run. Then, for each declared metric: its values, their median and
their spread, (max - min) / |median|, beside the gate's 20%; a
metric whose spread reaches the threshold is one the gate cannot judge
yet. Last, ``bench_summary --check`` on the store: the gate's own
verdicts, the newest run against the median of the runs before it.
Prints a ``bench_spread`` JSON line and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
THRESHOLD = 0.20        # bench_summary --check's default


def spread(values: list) -> dict:
    import numpy as np
    v = np.asarray(values, dtype=float)
    med, width = float(np.median(v)), float(v.max() - v.min())
    # equal values spread 0; unequal values about a median of 0 have no
    # relative spread (None), and the gate cannot judge them
    return {"values": values, "median": med,
            "spread": 0.0 if width == 0 else
            (width / abs(med) if med else None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)

    import torch
    from chip_smoke import BENCH_ARGS, run_bench
    from repro_torch.launch import bench_summary
    from repro_torch.results import ResultsStore
    if not torch.cuda.is_available():
        raise SystemExit("bench_spread needs a CUDA device")
    names = list(BENCH_ARGS)
    out = {}
    with tempfile.TemporaryDirectory() as store_dir:
        store = ResultsStore(store_dir)
        seconds = {name: [] for name in names}
        for run in range(args.runs):
            for name in names:
                module, bench_argv = BENCH_ARGS[name]
                rc, s, _ = run_bench(module, list(bench_argv) + [
                    "--store", store_dir] + (["--force"] if run else []))
                if rc != 0:
                    raise SystemExit(f"{name}: exit code {rc}")
                seconds[name].append(round(s, 3))
                print(f"[bench_spread] run {run + 1} {name}: {s:.1f} s",
                      flush=True)
        for name in names:
            recs = store.records(name)
            metrics = {}
            for key in recs[-1]["metrics"]:
                vals = [r["metrics"][key]["value"] for r in recs]
                if all(isinstance(x, (int, float)) for x in vals):
                    m = spread(vals)
                    m["gate_can_judge"] = (m["spread"] is not None and
                                           m["spread"] < THRESHOLD)
                    metrics[key] = m
            out[name] = {"config_hash": recs[-1]["config_hash"],
                         "runs": len(recs), "seconds": seconds[name],
                         "metrics": metrics}
            for key, m in metrics.items():
                pct = ("n/a" if m["spread"] is None
                       else f"{100 * m['spread']:.1f}%")
                print(f"[bench_spread] {name}.{key}: {m['values']} spread "
                      f"{pct} "
                      f"({'under' if m['gate_can_judge'] else 'AT OR OVER'}"
                      f" the {100 * THRESHOLD:.0f}% threshold)",
                      flush=True)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_summary.main(["--check", "--store", store_dir])
        verdicts = buf.getvalue().splitlines()
    for line in verdicts:
        print(f"[bench_spread] gate {line}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"bench_spread": out, "threshold": THRESHOLD,
                      "gate": verdicts}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

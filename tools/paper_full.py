#!/usr/bin/env python3
"""The paper suite at full size on the card, one module a process.

    python3 tools/paper_full.py [--budget SECONDS] [--out DIR]

Runs ``python -m repro_torch.launch.paper.run --full --only NAME`` for
each module of the suite in its own process, the quick ones first, each
under a cap of its own (``ORDER``) and all of them under ``--budget``,
into one results store under ``--out`` (default ``build/paper_full``;
each module's rows in ``NAME.log``). A
module that passes its cap is killed and recorded as not finished, so
one slow host baseline (the numpy Alg. 1, the Python Louvain on
gowalla or amazonbook) cannot keep the others from running. Prints each
module's status and seconds, the card's name and power limit, and a
``paper_full`` JSON line (also ``summary.json`` under ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (module, cap in seconds), the quick ones first
ORDER = [("kernel_bench", 180), ("fig4_convergence", 180),
         ("table6_scu", 300), ("table9_distance", 300),
         ("fig3_compression_ratio", 400), ("table5_weighting", 500),
         ("cluster_scale_bench", 300), ("fig1_balance_study", 600),
         ("table11_large_scale", 900), ("table4_recall", 1200),
         ("fig2_efficiency", 1500)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--budget", type=float, default=2900.0)
    p.add_argument("--out", default=os.path.join(ROOT, "build",
                                                 "paper_full"))
    args = p.parse_args(argv)
    deadline = time.time() + args.budget
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    res = {"smi": smi}
    for name, cap in ORDER:
        cap = min(cap, deadline - time.time())
        if cap < 30:
            res[name] = {"status": "not started"}
            continue
        t0 = time.time()
        with open(os.path.join(args.out, f"{name}.log"), "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.paper.run",
                 "--full", "--only", name, "--store",
                 os.path.join(args.out, "store")],
                cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
            try:
                rc = proc.wait(timeout=cap)
                status = "ok" if rc == 0 else f"exit code {rc}"
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                proc.wait()
                status = f"did not finish in {cap:.0f} s"
        res[name] = {"status": status, "seconds": time.time() - t0}
        print(name, res[name], flush=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(res, f, indent=1)
    print(smi)
    print(json.dumps({"paper_full": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

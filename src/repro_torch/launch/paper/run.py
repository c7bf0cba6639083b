"""The paper suite on the port: one module per paper table or figure
(port of ``benchmarks/run.py``).

  python -m repro_torch.launch.paper.run [--fast | --full] [--only NAME]
      [--device cuda|cpu] [--store DIR]

Prints ``name,us_per_call,derived`` CSV rows (one per measurement).
Fast mode (the default, spellable explicitly as --fast) uses the
small-scale synthetic datasets; --full runs the paper-scale ones
(slower, same orderings — table11 then exercises the 1M-node ladder
rung through the streamed solver).

Every module's run is recorded in the port's results store (bench
``suite``) keyed by {module, mode}: re-invoking with an unchanged config
on the same environment reports ``cached`` and runs nothing (--force
re-measures, --no-store opts out entirely). ``--profile`` wraps each
module in a ``torch.profiler`` capture. Runs on the CUDA device by
default; without one it raises unless ``--device cpu`` is asked for.
"""
from __future__ import annotations

import importlib
import sys
import traceback

from repro_torch.launch.paper.common import now
from repro_torch.results import BenchRun, higher, lower

# the reference's module names (the store's config key); each is
# repro_torch.launch.paper.<name> unless PATHS names another module
MODULES = [
    "kernel_bench",
    "fig1_balance_study",
    "fig2_efficiency",
    "fig4_convergence",
    "table4_recall",
    "fig3_compression_ratio",
    "table5_weighting",
    "table6_scu",
    "table9_distance",
    "table11_large_scale",
    "cluster_scale_bench",
]
PATHS = {"kernel_bench": "repro_torch.launch.kernel_bench",
         "cluster_scale_bench": "repro_torch.launch.cluster_scale"}


def module_path(name: str) -> str:
    return PATHS.get(name, f"repro_torch.launch.paper.{name}")


def main(argv=None, modules=None):
    suite = BenchRun("suite", description=__doc__)
    speed = suite.parser.add_mutually_exclusive_group()
    speed.add_argument("--fast", action="store_true",
                       help="small synthetic datasets (the default)")
    speed.add_argument("--full", action="store_true",
                       help="paper-scale datasets, incl. the 1M rung")
    suite.add_argument("--only", default=None)
    args = suite.parse(argv)
    device = str(suite.device)
    modules = MODULES if modules is None else modules
    mode = "full" if args.full else "fast"
    print("name,us_per_call,derived")
    t_all = now()
    failures = []
    n_cached = 0
    for name in modules:
        if args.only and args.only not in name:
            continue
        config = {"module": name, "mode": mode}
        hit = suite.cached(config)
        if hit is not None:
            print(f"# {name} cached (config {hit['config_hash']}, "
                  f"measured {hit.get('created_at', '?')}; --force "
                  f"re-runs)", flush=True)
            n_cached += 1
            continue
        t0 = now()
        try:
            mod = importlib.import_module(module_path(name))
            with suite.profile(name):
                rows = mod.run(fast=not args.full, device=device)
            dt = now() - t0
            payload_rows = [{"name": n, "us_per_call": us, "derived": d}
                            for n, us, d in (rows or [])]
            suite.emit(config,
                       {"wall_s": lower(dt),
                        "rows": higher(len(payload_rows))},
                       payload={"bench": "suite", "module": name,
                                "mode": mode, "rows": payload_rows})
            print(f"# {name} done in {dt:.1f}s", flush=True)
        except Exception as e:  # keep the suite running
            traceback.print_exc()
            failures.append((name, repr(e)))
            print(f"# {name} FAILED: {e!r}", flush=True)
    print(f"# total {now()-t_all:.1f}s, {len(failures)} failures, "
          f"{n_cached} cached")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

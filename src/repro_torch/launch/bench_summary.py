"""The port's perf trajectory at a glance, from its results store
(``python -m repro_torch.launch.bench_summary``; the store modes of
``benchmarks/bench_summary.py``):

    python -m repro_torch.launch.bench_summary [--store DIR]
        trajectory table: one line per (bench, config, fingerprint)
        group — the newest record's metrics and how deep its history runs

    python -m repro_torch.launch.bench_summary --check [--store DIR]
        the regression gate: each group's newest record against the
        MEDIAN of its last N stored records, every metric judged in the
        direction it declared at emission time. Warn-only by default;
        --strict exits 1 on any warning; --threshold sets the relative
        cutoff, --last-n the window.

    python -m repro_torch.launch.bench_summary --bless BENCH:CONFIG_HASH \\
        --reason "..." [--store DIR]
        accept an intentional regression: appends a bless marker, so that
        configuration's trajectory restarts after it (nothing is
        rewritten).

The store defaults to ``$REPRO_TORCH_RESULTS_STORE`` or
``results_store_torch/``. The reference's loose-file modes (``--dir``,
``--against``) read the TPU/CPU ``BENCH_*.json`` files, which the port's
store never takes as a baseline; they are not ported.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.results import (ResultsStore, check_store,
                                 default_store_root, dumps_record)


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


def store_groups(store: ResultsStore) -> list:
    """[(bench, config_hash, fingerprint_key, live_history)] in shard
    order."""
    out = []
    for bench in store.benches():
        seen = []
        for r in store.records(bench):
            key = (r.get("config_hash"), r.get("fingerprint_key"))
            if None in key or key in seen:
                continue
            seen.append(key)
            out.append((bench, key[0], key[1],
                        store.history(bench, key[0], key[1])))
    return out


def store_table(store: ResultsStore) -> int:
    groups = store_groups(store)
    if not groups:
        print(f"no records in results store {store.root!r}")
        return 1
    print(f"results store: {store.root}  "
          f"({len(store.benches())} benches, {len(groups)} trajectories)")
    print("-" * 72)
    for bench, chash, fkey, hist in groups:
        if not hist:
            print(f"{bench}[{chash[:8]}@{fkey}]  (blessed away, "
                  f"no live records)")
            continue
        cand = hist[-1]
        pairs = "  ".join(
            f"{k}={_fmt(m.get('value'))}"
            for k, m in (cand.get("metrics") or {}).items()
            if isinstance(m, dict))
        depth = f"n={len(hist)}"
        when = cand.get("created_at", "?")
        print(f"{bench}[{chash[:8]}@{fkey}]  {depth:<5} {when}")
        if pairs:
            print(f"    {pairs}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="results-store directory (default: "
                         "$REPRO_TORCH_RESULTS_STORE or "
                         "./results_store_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit every record as JSON instead of the table")
    ap.add_argument("--check", action="store_true",
                    help="regression gate: newest record per trajectory "
                         "vs the median of its stored history")
    ap.add_argument("--threshold", type=float, default=0.20,
                    help="relative regression threshold for --check")
    ap.add_argument("--last-n", type=int, default=5,
                    help="history window for the trajectory median")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 if --check produced any warning")
    ap.add_argument("--bless", default=None, metavar="BENCH:CONFIG_HASH",
                    help="append a bless marker accepting an intentional "
                         "regression for that configuration")
    ap.add_argument("--reason", default="",
                    help="why the regression in --bless is acceptable")
    args = ap.parse_args(argv)
    store = ResultsStore(args.store or default_store_root())

    if args.bless:
        if ":" not in args.bless:
            ap.error("--bless expects BENCH:CONFIG_HASH")
        bench, chash = args.bless.split(":", 1)
        marker = store.bless(bench, chash, reason=args.reason)
        print(f"blessed {bench}[{chash}] at {marker['created_at']}: "
              f"trajectory restarts after this marker")
        return 0

    if args.check:
        warnings, notes = check_store(store, threshold=args.threshold,
                                      last_n=args.last_n)
        for n in notes:
            print(f"note: {n}")
        for w in warnings:
            print(f"WARNING: {w}")
        if not warnings:
            print(f"check ok: no metric regressed more than "
                  f"{args.threshold:.0%} against its trajectory")
        return 1 if (warnings and args.strict) else 0

    if args.json:
        print(dumps_record(store.all_records()))
        return 0
    return store_table(store)


if __name__ == "__main__":
    sys.exit(main())

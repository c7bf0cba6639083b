"""The port's perf trajectory at a glance, from its results store
(``python -m repro_torch.launch.bench_summary``; a port of
``benchmarks/bench_summary.py``):

    python -m repro_torch.launch.bench_summary [--store [DIR]]
        trajectory table: one line per (bench, config, fingerprint)
        group — the newest record's metrics and how deep its history runs

    python -m repro_torch.launch.bench_summary --check [--store [DIR]]
        the regression gate: each group's newest record against the
        MEDIAN of its last N stored records, every metric judged in the
        direction it declared at emission time. Warn-only by default;
        --strict exits 1 on any warning; --threshold sets the relative
        cutoff, --last-n the window.

    python -m repro_torch.launch.bench_summary --bless BENCH:CONFIG_HASH \\
        --reason "..." [--store [DIR]]
        accept an intentional regression: appends a bless marker, so that
        configuration's trajectory restarts after it (nothing is
        rewritten).

The store defaults to ``$REPRO_TORCH_RESULTS_STORE`` or
``results_store_torch/``. Records imported from the loose ``BENCH_*.json``
files (``launch.migrate_store``, fingerprint key "imported") keep to
their own groups in the table: they never join a trajectory of the card,
never count as measured, and the gate reads them only for advisory
notes that name their platform, never for a warning or a --strict exit.

The reference's loose-file modes read a directory of ``BENCH_*.json``
files instead of the store: ``--dir DIR`` renders the legacy merge table,
and ``--check --against BASE_DIR`` compares two directories with the
legacy name-suffix direction heuristics (``results.legacy``: the only
place guessing a direction is still allowed). ``--trace TRACE_JSONL``
renders an obs trace export (``launch.obs_report``: tree and rollup)
before the table.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.results import (ResultsStore, check_store,
                                 default_store_root, dumps_record)
from repro_torch.results.legacy import legacy_direction, legacy_headline


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


# ---------------------------------------------------------------------------
# loose BENCH_*.json directories (the dir-vs-dir compare mode)
# ---------------------------------------------------------------------------
def summarize(directory: str = ".") -> dict:
    """{file stem: record} of every ``BENCH_*.json`` under ``directory``
    (an unreadable one as ``{"error": ...}``)."""
    merged = {}
    for path in sorted(glob.glob(os.path.join(directory, "BENCH_*.json"))):
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            with open(path) as f:
                merged[name] = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            merged[name] = {"error": str(e)}
    return merged


def check(directory: str, against: str, threshold: float = 0.20) -> list:
    """LEGACY dir-vs-dir compare: headline metrics of the records under
    ``directory`` vs the baseline records in ``against``, directions
    guessed from metric names (``results.legacy``). Returns warning
    strings; metrics without a guessable direction are skipped."""
    cur = summarize(directory)
    base = summarize(against)
    warnings = []
    for name, rec in cur.items():
        ref = base.get(name)
        if ref is None or "error" in rec or "error" in ref:
            continue
        ref_metrics = dict(legacy_headline(name, ref))
        for metric, value in legacy_headline(name, rec):
            bval = ref_metrics.get(metric)
            direction = legacy_direction(metric)
            if direction is None:
                continue
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                continue
            if not isinstance(bval, (int, float)) or isinstance(bval, bool):
                continue
            if bval == 0:
                # zero baseline: any increase of a lower-better count
                # (compiles, errors) is a regression; ratios undefined
                if direction == "lower" and value > 0:
                    warnings.append(
                        f"{name}: {metric} rose from 0 to {_fmt(value)}")
                continue
            rel = (value - bval) / abs(bval)
            bad = rel > threshold if direction == "lower" \
                else rel < -threshold
            if bad:
                warnings.append(
                    f"{name}: {metric} {_fmt(bval)} -> {_fmt(value)} "
                    f"({rel:+.0%}, {direction}-is-better, "
                    f"legacy name-heuristic direction)")
    return warnings


def legacy_table(directory: str) -> int:
    """The legacy merge table of a directory's ``BENCH_*.json`` files."""
    merged = summarize(directory)
    if not merged:
        print(f"no BENCH_*.json records under {directory!r}")
        return 1
    width = max(len(n) for n in merged)
    print(f"{'record':<{width}}  platform  headline metrics")
    print("-" * 72)
    for name, rec in merged.items():
        if "error" in rec:
            print(f"{name:<{width}}  -         unreadable: {rec['error']}")
            continue
        platform = rec.get("platform", "-")
        pairs = "  ".join(f"{k}={_fmt(v)}"
                          for k, v in legacy_headline(name, rec))
        print(f"{name:<{width}}  {platform:<8}  {pairs}")
    return 0


# ---------------------------------------------------------------------------
# the store: trajectory table and gate
# ---------------------------------------------------------------------------
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
    ap.add_argument("--dir", default=None,
                    help="legacy mode: directory holding loose "
                         "BENCH_*.json records")
    ap.add_argument("--store", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="results-store directory (flag alone or left out "
                         "uses $REPRO_TORCH_RESULTS_STORE or "
                         "./results_store_torch)")
    ap.add_argument("--json", action="store_true",
                    help="emit every record (or the merged legacy view) as "
                         "JSON instead of the table")
    ap.add_argument("--check", action="store_true",
                    help="regression gate: newest record per trajectory "
                         "vs the median of its stored history (store "
                         "mode), or dir-vs-dir legacy compare")
    ap.add_argument("--against", default=None,
                    help="legacy --check baseline directory")
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
    ap.add_argument("--trace", default=None, metavar="TRACE_JSONL",
                    help="render an obs trace export (tree + rollup) next "
                         "to the table: the file a bench run under --trace "
                         "wrote, recorded on its store record under "
                         "extra.obs.trace_file")
    args = ap.parse_args(argv)

    if args.trace:
        from repro_torch.launch.obs_report import report as obs_report
        print(obs_report(args.trace))
        print()

    use_store = args.store is not None or (args.dir is None
                                           and args.against is None)
    store = ResultsStore(args.store or default_store_root()) \
        if use_store else None

    if args.bless:
        if store is None:
            ap.error("--bless needs the store (drop --dir/--against)")
        if ":" not in args.bless:
            ap.error("--bless expects BENCH:CONFIG_HASH")
        bench, chash = args.bless.split(":", 1)
        marker = store.bless(bench, chash, reason=args.reason)
        print(f"blessed {bench}[{chash}] at {marker['created_at']}: "
              f"trajectory restarts after this marker")
        return 0

    if args.check:
        if store is not None:
            warnings, notes = check_store(store, threshold=args.threshold,
                                          last_n=args.last_n)
            for n in notes:
                print(f"note: {n}")
        else:
            warnings = check(args.dir or ".", args.against or args.dir
                             or ".", threshold=args.threshold)
        for w in warnings:
            print(f"WARNING: {w}")
        if not warnings:
            print(f"check ok: no metric regressed more than "
                  f"{args.threshold:.0%} against its trajectory")
        return 1 if (warnings and args.strict) else 0

    if store is not None:
        if args.json:
            print(dumps_record(store.all_records()))
            return 0
        return store_table(store)
    if args.json:
        print(dumps_record(summarize(args.dir or ".")))
        return 0
    return legacy_table(args.dir or ".")

if __name__ == "__main__":
    sys.exit(main())

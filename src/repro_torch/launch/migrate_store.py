"""Import the loose legacy ``BENCH_*.json`` files into the port's results
store (a port of ``benchmarks/migrate_store.py``).

Every loose ``BENCH_*.json`` under ``--dir`` becomes one imported record
in the store (default ``$REPRO_TORCH_RESULTS_STORE`` or
``results_store_torch/``, never the reference's ``results_store/``):

  * ``config_hash`` is derived from the record itself (the legacy files
    never recorded their bench invocation, so the record content is the
    best available configuration identity);
  * the fingerprint is the ``"imported"`` sentinel plus the platform the
    file itself names (the committed files were measured on a CPU or a
    TPU, never on the H100): an imported record never joins a trajectory
    of the card, never satisfies the skip-if-measured cache, and serves
    the gate only as an advisory fallback baseline that names its
    platform;
  * metrics come from the legacy headline extraction with the retired
    name-suffix direction heuristic (``results.legacy``), each tagged
    ``direction_source: "heuristic"``.

Re-running skips records whose (bench, config_hash) already sit in the
store, so the import imports nothing new the second time.

    python -m repro_torch.launch.migrate_store [--dir .] [--store DIR]
        [--dry-run]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from repro_torch.results import (ResultsStore, config_hash,
                                 default_store_root, make_record)
from repro_torch.results.legacy import legacy_metrics

__all__ = ["import_record", "main"]

# legacy filename -> the bench name its record declares (fallback when
# the record itself lacks a "bench" field)
_NAME_HINTS = {
    "BENCH_cluster": "cluster_scale",
    "BENCH_kernel": "kernel",
    "BENCH_server": "server",
    "BENCH_stream": "stream",
    "BENCH_serve": "serve_session",
    "BENCH_train": "train_pipeline",
    "BENCH_cluster_solve": "cluster_solve",
}


def import_record(store: ResultsStore, path: str, dry_run: bool = False):
    """-> ('imported'|'skipped'|'empty'|'unreadable', detail)."""
    name = os.path.splitext(os.path.basename(path))[0]
    try:
        with open(path) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return "unreadable", f"{name}: {e}"
    if not isinstance(rec, dict):
        return "unreadable", f"{name}: expected a JSON object"
    bench = rec.get("bench") or _NAME_HINTS.get(name, name)
    metrics = legacy_metrics(name, rec)
    if not metrics:
        return "empty", f"{name}: no metrics with a guessable direction"
    # the legacy record IS the config identity: same file content, same
    # hash, which is what makes re-running a no-op
    config = {"imported_from": os.path.basename(path), "legacy": rec}
    chash = config_hash(bench, config)
    if any(r.get("config_hash") == chash for r in store.records(bench)):
        return "skipped", f"{name}: already in store as {bench}[{chash}]"
    fp = {"imported": True, "platform": rec.get("platform")}
    record = make_record(bench, config, metrics, payload=rec, fp=fp)
    if record["fingerprint_key"] != "imported":
        raise RuntimeError(f"{name}: an imported record must carry the "
                           f"'imported' fingerprint key")
    if not dry_run:
        store.append(record)
    return "imported", (f"{name} -> {bench}[{chash}] "
                        f"({len(metrics)} metrics, platform "
                        f"{rec.get('platform')})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir", default=".",
                    help="directory holding the legacy BENCH_*.json files")
    ap.add_argument("--store", default=None,
                    help="results-store directory (default "
                         "$REPRO_TORCH_RESULTS_STORE or "
                         "./results_store_torch)")
    ap.add_argument("--dry-run", action="store_true",
                    help="report what would be imported, write nothing")
    args = ap.parse_args(argv)
    store = ResultsStore(args.store or default_store_root())
    paths = sorted(glob.glob(os.path.join(args.dir, "BENCH_*.json")))
    if not paths:
        print(f"no BENCH_*.json under {args.dir!r}; nothing to migrate")
        return 0
    counts = {}
    for path in paths:
        status, detail = import_record(store, path, dry_run=args.dry_run)
        counts[status] = counts.get(status, 0) + 1
        print(f"[{status}] {detail}")
    print("migration: " + ", ".join(f"{v} {k}"
                                    for k, v in sorted(counts.items()))
          + (" (dry run, store untouched)" if args.dry_run
             else f" -> {store.root}"))
    return 1 if counts.get("unreadable") else 0


if __name__ == "__main__":
    sys.exit(main())

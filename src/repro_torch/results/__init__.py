"""repro_torch.results — the port's content-keyed, append-only results
store and regression gate (port of ``repro.results``).

``record``   Record schema. ``config_hash(bench, config)`` content-keys
             a configuration (equal to the reference's for the same
             bench and config); ``fingerprint(device)`` captures
             platform / device kind / count / torch and CUDA versions
             and the card's power limit; ``higher(v)`` / ``lower(v)``
             declare a metric's good direction at emission time.
``store``    :class:`ResultsStore` — sharded JSONL, append-only (a copy
             of the reference's: either package reads the other's
             lines).
``gate``     ``check_store()`` — newest record per (bench, config_hash,
             fingerprint) group against the median of its last N.
``legacy``   the loose TPU/CPU ``BENCH_*.json`` files' headline metrics
             and the name-suffix direction heuristic, for
             ``launch.migrate_store`` (imported records, fingerprint key
             "imported": never a trajectory of the card, never the
             skip-if-measured cache, advisory gate notes only) and
             ``launch.bench_summary --dir/--against``.
``runner``   :class:`BenchRun` — the one API the port's benches emit
             through: flags, store append, ``--out`` mirror,
             skip-if-measured, ``torch.profiler`` capture and the obs
             trace export. Its default store is
             ``$REPRO_TORCH_RESULTS_STORE`` or ``results_store_torch/``.
"""
from .gate import check_store, compare_metrics
from .record import (SCHEMA_VERSION, canonical_json, config_hash,
                     dumps_record, fingerprint, fingerprint_key, higher,
                     lower, make_record, write_record)
from .runner import BenchRun, default_store_root
from .store import ResultsStore

__all__ = [
    "SCHEMA_VERSION", "canonical_json", "config_hash", "dumps_record",
    "fingerprint", "fingerprint_key", "higher", "lower", "make_record",
    "write_record", "ResultsStore", "BenchRun", "default_store_root",
    "check_store", "compare_metrics",
]

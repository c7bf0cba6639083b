"""Trajectory-aware perf-regression gate (a copy of
``repro.results.gate``: the same records give the same verdict lines).

For every configuration group in the store — (bench, config_hash,
fingerprint_key) — the newest record is the candidate and its baseline
is the **median of the last N earlier records in the same group**
(bless markers truncate the group, so an accepted regression restarts
the trajectory). Each metric is judged in its *declared* direction;
there is no name guessing for store-native records.

Groups with no same-fingerprint history fall back to the records
imported from the pre-store BENCH_*.json files (fingerprint key
"imported") for the same bench — but only ADVISORILY: their configs
may differ (the legacy files never recorded their invocation) and
their metric directions were heuristic, so those deltas are reported
as notes, never failures. Groups with no baseline at all likewise
produce an informational note: the first record of a new curve is how
a trajectory starts. Hard warnings come exclusively from a record
regressing against its own (config, fingerprint) trajectory.
"""
from __future__ import annotations

from statistics import median

from .store import ResultsStore

__all__ = ["check_store", "compare_metrics"]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3g}"
    return str(v)


def _metric_values(records: list, name: str) -> list:
    out = []
    for r in records:
        m = r.get("metrics", {}).get(name)
        if isinstance(m, dict):
            v = m.get("value")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.append(v)
    return out


def compare_metrics(cand: dict, baseline: list, threshold: float,
                    label: str, note: str = "") -> list:
    """Warnings for every candidate metric that moved more than
    ``threshold`` (relative) in its declared bad direction vs the
    median of the baseline records' same-named metric."""
    warnings = []
    for name, m in (cand.get("metrics") or {}).items():
        if not isinstance(m, dict):
            continue
        value = m.get("value")
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        bvals = _metric_values(baseline, name)
        if not bvals:
            continue
        bmed = median(bvals)
        hib = bool(m.get("higher_is_better"))
        if bmed == 0:
            # zero baseline: any increase of a lower-better count
            # (compiles, errors) is a regression; ratios are undefined
            if not hib and value > 0:
                warnings.append(
                    f"{label}: {name} rose from 0 to {_fmt(value)}{note}")
            continue
        rel = (value - bmed) / abs(bmed)
        bad = rel < -threshold if hib else rel > threshold
        if bad:
            direction = "higher" if hib else "lower"
            warnings.append(
                f"{label}: {name} median {_fmt(bmed)} -> {_fmt(value)} "
                f"({rel:+.0%}, {direction}-is-better, n={len(bvals)})"
                f"{note}")
    return warnings


def check_store(store: ResultsStore, threshold: float = 0.20,
                last_n: int = 5) -> tuple:
    """Gate every configuration group's newest record against its
    stored trajectory. Returns (warnings, notes): warnings are
    regressions beyond ``threshold``; notes are non-failing context
    (fresh curves, imported-baseline fallbacks)."""
    warnings, notes = [], []
    for bench in store.benches():
        records = store.records(bench)
        imported = [r for r in records
                    if r.get("fingerprint_key") == "imported"]
        groups = {}
        for r in records:
            key = (r.get("config_hash"), r.get("fingerprint_key"))
            if None in key or key[1] == "imported":
                continue
            groups.setdefault(key, None)
        for chash, fkey in groups:
            hist = store.history(bench, chash, fkey)
            if not hist:
                continue        # fully pre-bless: nothing live to gate
            cand = hist[-1]
            baseline = hist[:-1][-last_n:]
            if not baseline and imported:
                # advisory only: the legacy records never recorded
                # their invocation, so config mismatch is likely and
                # a delta here must not fail CI
                notes.append(
                    f"{bench}[{chash[:8]}@{fkey}]: no same-fingerprint "
                    f"history yet; advisory compare against "
                    f"{min(len(imported), last_n)} imported legacy "
                    f"record(s)")
                notes += compare_metrics(
                    cand, imported[-last_n:], threshold,
                    label=f"{bench}[{chash[:8]}@{fkey}]",
                    note=(" [vs imported legacy baseline: config may "
                          "differ, directions were heuristic]"))
                continue
            if not baseline:
                notes.append(
                    f"{bench}[{chash[:8]}@{fkey}]: first record of this "
                    f"trajectory ({len(hist)} total) — nothing to gate "
                    f"against yet")
                continue
            warnings += compare_metrics(
                cand, baseline, threshold,
                label=f"{bench}[{chash[:8]}@{fkey}]")
    return warnings, notes

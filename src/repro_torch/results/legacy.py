"""Legacy BENCH_*.json support: headline extraction + the retired
name-suffix direction heuristic (the port's own copy of
``repro.results.legacy``: the same files give the same metrics).

Before the results store, every bench overwrote a loose BENCH_*.json
and the summary guessed each metric's good direction from its name.
Both survive here for exactly two callers:

  * ``launch.migrate_store`` — importing the committed legacy files into
    the port's store as ``imported`` records (each extracted metric is
    tagged ``direction_source: "heuristic"`` so the gate can say that the
    direction was guessed, not declared);
  * ``launch.bench_summary``'s legacy directory-vs-directory modes
    (``--dir``, ``--check --against``).

The committed files were measured on a TPU or a CPU, never on the H100:
an imported record never joins a trajectory of the card, never satisfies
the skip-if-measured cache, and gives the gate advisory notes only.
New benchmarks must never route through this module — directions are
declared at emission time via ``repro_torch.results.higher/lower``.
"""
from __future__ import annotations

__all__ = ["legacy_headline", "legacy_direction", "legacy_metrics"]


def legacy_headline(name: str, rec: dict) -> list:
    """(metric, value) pairs worth a trajectory line, per legacy bench
    kind — the extraction bench_summary's table historically applied to
    a raw BENCH_*.json record."""
    kind = rec.get("bench", name)
    if kind == "serve_session":
        rows = [r for r in rec.get("records", []) if "p50_ms" in r]
        if not rows:
            return []
        best = min(rows, key=lambda r: r["p50_ms"])
        return [("best p50_ms", best["p50_ms"]),
                ("backend", best.get("backend", "?")),
                ("buckets", len(rec.get("buckets", []))),
                ("max compiles", max(r.get("compiles", 0) for r in rows))]
    if kind in ("cluster_solve", "train_pipeline"):
        rows = [r for r in rec.get("records", []) if isinstance(r, dict)]
        out = [("records", len(rows))]
        sp = [r["speedup_vs_seed"] for r in rows
              if isinstance(r.get("speedup_vs_seed"), (int, float))]
        if sp:
            out.append(("best speedup_vs_seed", max(sp)))
        return out
    if kind == "server":
        keys = ("sustained_qps", "e2e_p50_ms", "e2e_p99_ms",
                "queue_delay_p99_ms", "swap_pause_ms",
                "compiles_under_load")
        return [(k, rec[k]) for k in keys if k in rec]
    if kind == "stream":
        keys = ("cold_assign_first_ms", "cold_assign_warm_p50_ms",
                "swap_p99_ms",
                "refresh_steady_frac_of_full", "recall_frozen",
                "recall_stream", "recall_full", "recall_gap_recovered",
                "compiles")
        return [(k, rec[k]) for k in keys if k in rec]
    if kind == "cluster_scale":
        rungs = [r for r in rec.get("rungs", []) if isinstance(r, dict)]
        out = []
        for r in rungs:
            tag = r.get("rung", "?")
            if isinstance(r.get("sweep_ms"), (int, float)):
                out.append((f"{tag} sweep_ms", r["sweep_ms"]))
            if isinstance(r.get("peak_device_bytes"), (int, float)):
                out.append((f"{tag} peak_mb",
                            round(r["peak_device_bytes"] / 1e6, 1)))
            if isinstance(r.get("blocks_per_s"), (int, float)):
                out.append((f"{tag} blocks_per_s", r["blocks_per_s"]))
        recalls = [r["cold"]["minhash_recall"] for r in rungs
                   if isinstance(r.get("cold"), dict)
                   and isinstance(r["cold"].get("minhash_recall"),
                                  (int, float))]
        if recalls:
            out.append(("min minhash_recall", min(recalls)))
        bitwise = [r["bitwise_equal_inmem"] for r in rungs
                   if "bitwise_equal_inmem" in r]
        if bitwise:
            out.append(("bitwise_parity", "ok" if all(bitwise) else "FAIL"))
        return out
    if kind == "kernel":
        fused = [r for r in rec.get("fused", [])
                 if isinstance(r, dict) and "us_per_call" in r]
        out = [("fused records", len(fused))]
        for variant, label in (("fused", "fused_gbps"),
                               ("fused_int8", "int8_gbps")):
            rows = [r["achieved_gbps"] for r in fused
                    if r.get("variant") == variant
                    and isinstance(r.get("achieved_gbps"), (int, float))]
            if rows:
                out.append((f"best {label}", max(rows)))
        errors = [r for r in rec.get("codebook_lookup", [])
                  if isinstance(r, dict) and "error" in r]
        out.append(("lookup errors", len(errors)))
        return out
    # unknown bench kind: surface its scalar fields
    return [(k, v) for k, v in rec.items()
            if isinstance(v, (int, float, str)) and k != "bench"][:6]


# metric-direction heuristics — LEGACY/IMPORTED RECORDS ONLY. A metric
# whose name matches a HIGHER token is good-when-up (speedups,
# bandwidth, recall); otherwise a LOWER token marks it good-when-down
# (latencies, compile/error counts). HIGHER is checked first so e.g.
# "speedup_vs_seed" never trips on "_s".
_HIGHER = ("speedup", "gbps", "recall", "recovered", "records", "buckets",
           "qps", "per_s")
_LOWER = ("_ms", "_us", "us_per", "compiles", "_s", "frac_of_full", "err",
          "errors", "_mb")


def legacy_direction(metric: str):
    """'higher' / 'lower' if the metric name has a guessable good
    direction, else None (such metrics are skipped by legacy checks)."""
    if any(t in metric for t in _HIGHER):
        return "higher"
    if any(t in metric for t in _LOWER):
        return "lower"
    return None


def legacy_metrics(name: str, rec: dict) -> dict:
    """Declared-direction metrics dict for an imported legacy record:
    headline extraction + the name heuristic, every entry tagged
    ``direction_source: "heuristic"`` so downstream consumers know the
    direction was guessed."""
    from .record import higher, lower
    out = {}
    for metric, value in legacy_headline(name, rec):
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        direction = legacy_direction(metric)
        if direction is None:
            continue
        make = higher if direction == "higher" else lower
        # normalize "best p50_ms" -> "best_p50_ms" so store-native
        # records (which declare underscore names) line up with the
        # imported fallback baseline metric-by-metric
        out[metric.replace(" ", "_")] = make(value,
                                             direction_source="heuristic")
    return out

"""Serving roofline of the port: the fused top-k sweep of the kernel
bench against the H100's bounds (``python -m repro_torch.launch.roofline
--serving``; a port of the ``--serving`` part of
``benchmarks/roofline.py``, bench ``roofline_serving``).

    python -m repro_torch.launch.roofline --serving store [--store DIR]
    python -m repro_torch.launch.roofline --serving kernel_record.json

Each fused-sweep row of a kernel record (``kernel_bench --json``, or the
newest ``kernel`` record of the port's store with the literal ``store``)
carries its bytes and its measured time. The reference assumes the
scorer is memory-bound; on this card it need not be (at B = 512 users
against 91,599 items the f32 products take longer than reading the
items from HBM), so each row gets both terms at the H100 SXM's
published peaks, 3.35 TB/s of HBM and 67 TFLOP/s in f32 outside the
tensor cores:

  bytes_us      bytes_moved / HBM rate
  ops_us        2 B N d score products-and-adds (+ N (H-1) d to expand
                codebook rows, + B N scale multiplies for int8 rows)
                / the f32 rate
  bound_us      the larger, and ``bound_by`` which ("bytes" or
                "operations")
  hbm_frac      achieved bytes/s against the HBM rate (the reference's
                column, kept under its name)
  roofline_frac bound_us / us_per_call

A record measured on the CPU gets a note instead of a verdict.
``--json`` / ``--out`` emit the derived table as a ``roofline_serving``
record through ``BenchRun``.
"""
from __future__ import annotations

import json
import sys

from repro_torch.results import BenchRun, higher

HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3
F32_OPS = 67e12            # f32 operations/s outside the tensor cores

__all__ = ["serving_roofline", "print_serving_table", "serving_metrics",
           "HBM_BW", "F32_OPS"]


def _ops(rec: dict) -> float:
    b, n, d = rec["B"], rec["N"], rec["d"]
    ops = 2.0 * b * n * d
    ops += n * (rec.get("H", 1) - 1) * d
    if "int8" in rec["variant"]:
        ops += b * n
    return ops


def serving_roofline(fused_records, peak_bw: float = HBM_BW,
                     peak_ops: float = F32_OPS):
    """Roofline terms for each row of the fused serving sweep; rows
    without a time pass through so bench errors stay visible."""
    out = []
    for rec in fused_records:
        if not isinstance(rec, dict) or "us_per_call" not in rec:
            out.append(dict(rec) if isinstance(rec, dict) else
                       {"error": repr(rec)})
            continue
        us = float(rec["us_per_call"])
        nbytes = float(rec["bytes_moved"])
        bytes_us = nbytes / peak_bw * 1e6
        ops_us = _ops(rec) / peak_ops * 1e6
        bound_us = max(bytes_us, ops_us)
        achieved = nbytes / (us / 1e6)
        out.append({
            "variant": rec["variant"], "B": rec["B"], "N": rec["N"],
            "d": rec["d"], "K": rec["K"], "us_per_call": us,
            "bytes_us": round(bytes_us, 4), "ops_us": round(ops_us, 4),
            "bound_us": round(bound_us, 4),
            "bound_ms": round(bound_us / 1e3, 7),
            "bound_by": "bytes" if bytes_us >= ops_us else "operations",
            "achieved_gbps": round(achieved / 1e9, 4),
            "hbm_frac": round(achieved / peak_bw, 6),
            "roofline_frac": round(bound_us / us, 6),
            "speedup_vs_dense": rec.get("speedup_vs_dense"),
        })
    return out


def print_serving_table(record: dict, peak_bw: float = HBM_BW,
                        peak_ops: float = F32_OPS):
    """Render the fused sweep of a kernel record against both bounds."""
    platform = record.get("platform", "?")
    rows = serving_roofline(record.get("fused", []), peak_bw, peak_ops)
    hdr = (f"{'variant':14s} {'B':>5s} {'N':>7s} {'d':>4s} {'K':>4s} "
           f"{'us':>11s} {'bound_us':>9s} {'by':>10s} {'GB/s':>9s} "
           f"{'%hbm':>7s} {'%roof':>7s} {'vs_dense':>9s}")
    print(f"serving roofline vs {peak_bw / 1e12:.2f} TB/s HBM and "
          f"{peak_ops / 1e12:.0f} TFLOP/s f32 (platform: {platform}, "
          f"device: {record.get('device', '?')})")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        if "us_per_call" not in r:
            print(f"{r.get('variant', '?'):14s} "
                  f"error: {r.get('error', '?')[:48]}")
            continue
        sp = r["speedup_vs_dense"]
        print(f"{r['variant']:14s} {r['B']:5d} {r['N']:7d} {r['d']:4d} "
              f"{r['K']:4d} {r['us_per_call']:11.1f} {r['bound_us']:9.3f} "
              f"{r['bound_by']:>10s} {r['achieved_gbps']:9.3f} "
              f"{100 * r['hbm_frac']:6.2f}% {100 * r['roofline_frac']:6.2f}% "
              f"{(f'{sp:.2f}x' if sp is not None else '-'):>9s}")
    if platform != "cuda":
        print(f"NOTE: record was produced on {platform!r}: the kernels' "
              f"plain versions on the host, so the shares against the "
              f"H100's bounds are not a device verdict; re-run "
              f"kernel_bench --json on the card to measure.")
    return rows


def _load_serving_source(spec: str, store):
    """The kernel sweep record + an identity dict for the derived
    record's config. ``spec`` is a record path, or the literal "store"
    for the newest kernel record in the store."""
    if spec != "store":
        with open(spec) as f:
            return json.load(f), {"source": spec}
    if store is None:
        raise SystemExit("--serving store needs a store (drop --no-store)")
    recs = store.records("kernel")
    if not recs:
        raise SystemExit(f"no 'kernel' records under {store.root!r}; "
                         f"run kernel_bench --json first")
    rec = recs[-1]
    return rec.get("payload", {}), {
        "source": "store",
        "kernel_config_hash": rec.get("config_hash"),
        "kernel_created_at": rec.get("created_at"),
        "kernel_fingerprint_key": rec.get("fingerprint_key"),
    }


def serving_metrics(rows) -> dict:
    """Declared-direction headline metrics of the serving roofline: the
    reference's, plus ``best_roofline_frac`` for rows that carry it."""
    timed = [r for r in rows if "us_per_call" in r]
    out = {"roofline_rows": higher(len(timed))}
    fracs = [r["hbm_frac"] for r in timed
             if isinstance(r.get("hbm_frac"), (int, float))]
    if fracs:
        out["best_hbm_frac"] = higher(max(fracs))
    gbps = [r["achieved_gbps"] for r in timed
            if isinstance(r.get("achieved_gbps"), (int, float))]
    if gbps:
        out["best_achieved_gbps"] = higher(max(gbps))
    roof = [r["roofline_frac"] for r in timed
            if isinstance(r.get("roofline_frac"), (int, float))]
    if roof:
        out["best_roofline_frac"] = higher(max(roof))
    return out


def main(argv=None):
    run = BenchRun("roofline_serving", description=__doc__)
    run.add_argument("--serving", required=True,
                     metavar="KERNEL_RECORD_JSON|store",
                     help="render the fused serving sweep of a kernel "
                          "record (or the newest store 'kernel' record) "
                          "against the H100's bounds")
    args = run.parse(argv)
    record, source = _load_serving_source(args.serving, run.store)
    rows = print_serving_table(record)
    if args.json or args.out:
        config = {**source, "peak_bw": HBM_BW, "peak_ops": F32_OPS}
        payload = {"bench": "roofline_serving",
                   "platform": record.get("platform", "?"),
                   "device": record.get("device", "?"),
                   "peak_bw": HBM_BW, "peak_ops": F32_OPS, "rows": rows}
        run.emit(config, serving_metrics(rows), payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())

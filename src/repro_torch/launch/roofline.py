"""Roofline of the port (a port of ``benchmarks/roofline.py``): the
dry run's three terms a cell, and the serving sweep's bounds.

    python -m repro_torch.launch.roofline --results dryrun.json [--markdown]
    python -m repro_torch.launch.roofline --cell gemma2-9b:train_4k
    python -m repro_torch.launch.roofline --serving store [--store DIR]
    python -m repro_torch.launch.roofline --serving kernel_record.json

**The dry-run half** (``--results``: a ``launch.dryrun --out`` file,
``--markdown`` for one markdown row a cell; ``--cell arch:shape``: one
cell reckoned live). Each ``ok`` record with
``op_metrics`` (``launch.op_analysis``, one rank's step) gets three terms
a rank, at the H100 SXM's published peaks. These are assumed peaks, not
measurements:

  compute     Σ over dtypes of dot_flops/<dtype> at that dtype's rate:
              f32 at 67 TFLOP/s (torch's default f32 matmul, outside the
              tensor cores; gemma's f32 promotion, ROADMAP Queue 3 #7),
              bf16/f16 dense at 989 TFLOP/s, fp8 at twice that; plus the
              kernels' own operations (``kernel_ops/f32`` at the f32 rate,
              ``kernel_ops/16`` at the 16-bit rate)
  memory      hbm_bytes at 3.35 TB/s (the bytes each op reads and writes:
              the port runs eagerly, so there is no fused lower bracket,
              unlike the reference's ``memory_lo_s..memory_hi_s``)
  collective  collective bytes over NVLink at 450 GB/s a direction
              (groups inside one node of 8 consecutive ranks) plus those
              over the network at 400 Gb/s NDR, 50 GB/s a GPU

``bottleneck`` is the largest term, ``useful_ratio`` the analytic
``model_flops`` a rank over the counted dot FLOPs, ``roofline_frac``
the compute term's share of the largest (the reference's columns).
``model_flops`` is the reference's arithmetic on the port's own
configs: 6·N·D for an LM (N the active non-embedding params) with the
head and attention, MLP-dominated counts for the recsys and GNN
families, NaN for the cf cell.

**The serving half** (``--serving``): each fused-sweep row of a kernel
record (``kernel_bench --json``, or the newest ``kernel`` record of the
port's store that was not imported from a loose ``BENCH_*.json`` file,
with the literal ``store``) carries its bytes and its measured time. The
reference assumes the scorer is memory-bound; on this card it need not
be (at B = 512 users against 91,599 items the f32 products take longer
than reading the items from HBM), so each row gets both terms:

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

import argparse
import json
import math
import sys
from typing import Optional

from repro_torch.kernels.cost import (F16_OPS_PER_S, F32_OPS_PER_S,
                                     HBM_BYTES_PER_S)
from repro_torch.results import BenchRun, higher

# the H100 SXM's published peaks (assumed, not measured); the HBM, f32 and
# 16-bit rates are the kernel table's (kernels/cost.py). A dot's rate by
# its dtype: the tensor rate for 16-bit operands, twice it for fp8, else
# the f32 rate.
DTYPE_OPS = {"bf16": F16_OPS_PER_S, "f16": F16_OPS_PER_S,
             "f8e4m3fn": 2 * F16_OPS_PER_S, "f8e5m2": 2 * F16_OPS_PER_S}
NVLINK_BW = 450e9          # bytes/s a direction, inside a node of 8
NETWORK_BW = 50e9          # bytes/s a GPU, 400 Gb/s NDR between nodes

__all__ = ["model_flops", "roofline_terms", "print_table", "print_markdown",
           "serving_roofline", "print_serving_table", "serving_metrics",
           "DTYPE_OPS", "NVLINK_BW", "NETWORK_BW"]


def model_flops(arch_id: str, shape_name: str, kind: str) -> float:
    """Analytic 6*N*D (N = active non-embedding params, D = tokens) for
    LMs; dense-layer dominated analytic counts for the other families.
    GLOBAL flops (divide by ranks for a rank's); the reference's
    arithmetic (``benchmarks/roofline.py:39-117``) on the port's
    configs."""
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as R
    spec = get_arch(arch_id)
    cfg = spec.full_config()
    dims = spec.shape(shape_name).dims
    if spec.family == "lm":
        d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
        per_layer = (2 * d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd
                     + cfg.n_heads * cfg.hd * d)
        if cfg.moe:
            per_layer += 3 * cfg.moe.top_k * d * f
        else:
            per_layer += 3 * d * f
        n_active = cfg.n_layers * per_layer
        n_embed_out = d * v
        tokens = dims["global_batch"] * (dims["seq_len"]
                                         if kind in ("train", "prefill")
                                         else 1)
        mult = 3 if kind == "train" else 1      # fwd + bwd(2x)
        flops = 2 * n_active * tokens * mult
        flops += 2 * n_embed_out * tokens * mult   # lm head
        skv = dims["seq_len"]
        n_global = sum(1 for k in cfg.block_pattern if k == "global") \
            * cfg.n_blocks
        n_local = cfg.n_layers - n_global
        if kind in ("train", "prefill"):
            att = (2 * 2 * cfg.n_heads * cfg.hd
                   * (n_global * skv * skv / 2
                      + n_local * skv * min(cfg.window, skv)))
            flops += att * dims["global_batch"] * mult
        else:
            span_local = min(cfg.window, skv)
            flops += (2 * 2 * cfg.n_heads * cfg.hd
                      * (n_global * skv + n_local * span_local)
                      * dims["global_batch"])
        return flops
    if spec.family == "recsys":
        b = dims.get("n_candidates", dims.get("batch", 1)) \
            if kind == "retrieval" else dims["batch"]
        if isinstance(cfg, (R.BERT4RecConfig, R.SASRecConfig)):
            d, l = cfg.embed_dim, cfg.seq_len
            per_tok = cfg.n_blocks * (4 * d * d + 2 * 4 * d * d + 2 * l * d)
            n = 2 * per_tok * dims["batch"] * l
            if isinstance(cfg, R.BERT4RecConfig) and kind == "train":
                n += 2 * dims["batch"] * cfg.n_mask * cfg.n_neg * d
            mult = 3 if kind == "train" else 1
            return n * mult

        def mlp_flops(dims_):
            return sum(2 * i * o for i, o in zip(dims_[:-1], dims_[1:]))
        if isinstance(cfg, R.DLRMConfig):
            f1 = mlp_flops((cfg.n_dense,) + cfg.bot_mlp)
            nint = (cfg.n_sparse + 1)
            f2 = 2 * nint * nint * cfg.embed_dim
            f3 = mlp_flops((cfg.bot_mlp[-1] + nint * (nint - 1) // 2,)
                           + cfg.top_mlp)
            per = f1 + f2 + f3
        else:
            per = mlp_flops((cfg.n_sparse * cfg.embed_dim,) + cfg.mlp + (1,))
        mult = 3 if kind == "train" else 1
        return per * b * mult
    if spec.family == "gnn":
        d = cfg.d_hidden
        e = dims.get("n_edges", 64 * dims.get("batch", 1))
        n = dims.get("n_nodes", 30 * dims.get("batch", 1))
        per_edge = 2 * (cfg.n_rbf * d + d * d)
        per_node = 2 * (3 * d * d) + 2 * dims.get("d_feat", 0) * d
        return (per_edge * e + per_node * n) * cfg.n_interactions * 3
    return float("nan")


def _ranks(rec: dict) -> int:
    """The ranks of a dry-run record's mesh ("16x16" -> 256)."""
    return math.prod(int(x) for x in rec["mesh"].split("x"))


def compute_s(om: dict) -> float:
    """Seconds of the counted dot FLOPs (each dtype at its rate) and the
    kernels' operations at the H100's peaks."""
    t = sum(v / DTYPE_OPS.get(k.split("/", 1)[1], F32_OPS_PER_S)
            for k, v in om.items() if k.startswith("dot_flops/"))
    return (t + om.get("kernel_ops/f32", 0.0) / F32_OPS_PER_S
            + om.get("kernel_ops/16", 0.0) / F16_OPS_PER_S)


def terms_s(om: dict) -> dict:
    """{compute_s, memory_s, collective_s, bottleneck} of op metrics."""
    t_c = compute_s(om)
    t_m = om.get("hbm_bytes", 0.0) / HBM_BYTES_PER_S
    t_x = (om.get("coll_bytes/nvlink", 0.0) / NVLINK_BW
           + om.get("coll_bytes/network", 0.0) / NETWORK_BW)
    dominant = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))
    return {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
            "bottleneck": dominant[1], "bound_s": dominant[0]}


def roofline_terms(rec: dict, chips: Optional[int] = None) -> dict:
    """The three terms a rank of a dry-run record (module docstring), its
    bottleneck, ``model_flops_per_dev``, ``useful_ratio`` and
    ``roofline_frac``; ``chips`` defaults to the record's mesh's ranks."""
    om = rec.get("op_metrics", {})
    out = terms_s(om)
    dot = om.get("dot_flops", 0.0)
    chips = _ranks(rec) if chips is None else chips
    mf = model_flops(rec["arch"], rec["shape"], rec["kind"])
    top = out["bound_s"]
    out.update({
        "model_flops_per_dev": mf / chips if mf == mf else float("nan"),
        "useful_ratio": (mf / chips) / dot if dot and mf == mf
        else float("nan"),
        "roofline_frac": out["compute_s"] / top if top > 0
        else float("nan")})
    return out


def print_table(results, chips: Optional[int] = None) -> list:
    """One line a record: the three terms (s), the bottleneck, the useful
    ratio, the compute share and the temporaries a rank."""
    hdr = (f"{'arch':18s} {'shape':14s} {'mesh':8s} {'comp_s':>10s} "
           f"{'mem_s':>10s} {'coll_s':>10s} {'bound':>10s} {'useful':>7s} "
           f"{'roofl%':>7s} {'tempGB':>7s}")
    print(f"roofline a rank at the H100 SXM's published peaks (assumed): "
          f"f32 {F32_OPS_PER_S / 1e12:.0f} / bf16 "
          f"{F16_OPS_PER_S / 1e12:.0f} TFLOP/s, "
          f"HBM {HBM_BYTES_PER_S / 1e12:.2f} TB/s, NVLink "
          f"{NVLINK_BW / 1e9:.0f} GB/s, network {NETWORK_BW / 1e9:.0f} GB/s")
    print(hdr)
    print("-" * len(hdr))
    rows = []
    for rec in results:
        head = f"{rec['arch']:18s} {rec['shape']:14s} {rec['mesh']:8s}"
        if rec["ok"] == "skipped":
            print(f"{head} skipped: {(rec.get('skip') or '')[:48]}")
            continue
        if rec["ok"] is not True:
            print(f"{head} FAILED")
            continue
        if "op_metrics" not in rec:
            why = ("does not build: " + rec.get("why", "")[:40]
                   if rec.get("builds") is False else "arguments only")
            print(f"{head} {why}")
            continue
        t = roofline_terms(rec, chips)
        rows.append((rec, t))
        temp = rec.get("memory_analysis", {}).get("temp_size_in_bytes", 0)
        print(f"{head} {t['compute_s']:10.4g} {t['memory_s']:10.4g} "
              f"{t['collective_s']:10.4g} {t['bottleneck']:>10s} "
              f"{t['useful_ratio']:7.2f} {100 * t['roofline_frac']:6.1f}% "
              f"{temp / 1e9:7.2f}")
    return rows


def _ops(rec: dict) -> float:
    b, n, d = rec["B"], rec["N"], rec["d"]
    ops = 2.0 * b * n * d
    ops += n * (rec.get("H", 1) - 1) * d
    if "int8" in rec["variant"]:
        ops += b * n
    return ops


def _pair(values, fmt: str) -> str:
    """One value a mesh, "a / b" where the meshes differ."""
    txt = [format(v, fmt) for v in values]
    return txt[0] if len(set(txt)) == 1 else " / ".join(txt)


def print_markdown(results) -> list:
    """The records as one markdown row a cell, each mesh's value in mesh
    order ("a / b" where they differ): dot TFLOP, HBM GB, collective GB
    and temporaries GB a rank, the three terms (s) and the bottleneck;
    a cell that does not build, or is skipped, says so."""
    cells = {}
    for rec in results:
        cells.setdefault((rec["arch"], rec["shape"]), []).append(rec)
    print("| cell | meshes | dot TFLOP | HBM GB | coll GB | temp GB | "
          "compute s | memory s | collective s | bound |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    rows = []
    for (arch, shape), recs in cells.items():
        meshes = " / ".join(r["mesh"] for r in recs)
        done = [r for r in recs if r["ok"] is True and "op_metrics" in r]
        if len(done) != len(recs):
            why = ("skipped" if recs[0]["ok"] == "skipped" else
                   "does not build (Queue 3 #15)"
                   if recs[0].get("builds") is False else "no op metrics")
            print(f"| {arch} {shape} | {meshes} | {why} |||||||")
            continue
        terms = [roofline_terms(r) for r in done]
        om = [r["op_metrics"] for r in done]
        temp = [r["memory_analysis"]["temp_size_in_bytes"] / 1e9
                for r in done]
        print(f"| {arch} {shape} | {meshes} | "
              f"{_pair([m['dot_flops'] / 1e12 for m in om], '.4g')} | "
              f"{_pair([m['hbm_bytes'] / 1e9 for m in om], '.4g')} | "
              f"{_pair([m['coll_bytes_total'] / 1e9 for m in om], '.4g')} | "
              f"{_pair(temp, '.4g')} | "
              f"{_pair([t['compute_s'] for t in terms], '.4g')} | "
              f"{_pair([t['memory_s'] for t in terms], '.4g')} | "
              f"{_pair([t['collective_s'] for t in terms], '.4g')} | "
              f"{' / '.join(dict.fromkeys(t['bottleneck'] for t in terms))}"
              f" |")
        rows.append(((arch, shape), terms))
    return rows


def serving_roofline(fused_records, peak_bw: float = HBM_BYTES_PER_S,
                     peak_ops: float = F32_OPS_PER_S):
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


def print_serving_table(record: dict, peak_bw: float = HBM_BYTES_PER_S,
                        peak_ops: float = F32_OPS_PER_S):
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
    # records imported from the loose BENCH_*.json files (launch.
    # migrate_store) were measured elsewhere (a TPU, a CPU): never a source
    recs = [r for r in store.records("kernel")
            if r.get("fingerprint_key") != "imported"]
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


def dryrun_main(argv=None) -> int:
    """``--results FILE`` / ``--cell arch:shape``: the dry-run half (no
    device, no store)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default="dryrun_single_pod.json",
                    help="a launch.dryrun --out file")
    ap.add_argument("--cell", default=None,
                    help="arch:shape (reckoned live by launch.dryrun)")
    ap.add_argument("--markdown", action="store_true",
                    help="one markdown row a cell, the meshes side by side")
    args = ap.parse_args(argv)
    if args.cell:
        from repro_torch.launch.dryrun import run_cell
        arch, shape = args.cell.split(":")
        print_table([run_cell(arch, shape, verbose=True)])
        return 0
    with open(args.results) as f:
        results = json.load(f)
    (print_markdown if args.markdown else print_table)(results)
    return 0


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--serving", default=None)
    if pre.parse_known_args(argv)[0].serving is None:
        return dryrun_main(argv)
    run = BenchRun("roofline_serving", description=__doc__)
    run.add_argument("--serving", required=True,
                     metavar="KERNEL_RECORD_JSON|store",
                     help="render the fused serving sweep of a kernel "
                          "record (or the newest store 'kernel' record "
                          "not imported) against the H100's bounds")
    args = run.parse(argv)
    record, source = _load_serving_source(args.serving, run.store)
    rows = print_serving_table(record)
    if args.json or args.out:
        config = {**source, "peak_bw": HBM_BYTES_PER_S,
                  "peak_ops": F32_OPS_PER_S}
        payload = {"bench": "roofline_serving",
                   "platform": record.get("platform", "?"),
                   "device": record.get("device", "?"),
                   "peak_bw": HBM_BYTES_PER_S, "peak_ops": F32_OPS_PER_S,
                   "rows": rows}
        run.emit(config, serving_metrics(rows), payload)
    return 0


if __name__ == "__main__":
    sys.exit(main())

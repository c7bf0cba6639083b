"""The hillclimb of the dry run (a port of
``benchmarks/perf_iterations.py``): config and mapping variants of four
cells, each reckoned by ``launch.dryrun`` (one rank's step on the
production mesh, on meta tensors) and put against the roofline
(``launch.roofline``), one line a variant.

  * kimi-k2-1t-a32b:train_4k  — the most collective-bound cell
  * gemma3-12b:train_4k       — the TP-16 all-reduce tax
  * qwen1.5-32b:train_4k      — generalizing the DP mapping
  * dlrm-mlperf:train_batch   — the paper's technique (BACO codebooks)

A variant the port cannot build is printed and recorded as not built,
with its error: kimi's ``moe_impl="gspmd"`` (the port has one
expert-parallel dispatch: ROADMAP Queue 3 #19), a mapping whose query
heads do not divide the model axis (qwen1.5-32b's 40 heads on 16 ranks:
Queue 3 #15), and a pure-DP mapping whose microbatches do not split over
its 256 data ranks (Queue 3 #21).

    python -m repro_torch.launch.perf_iterations [--cell kimi|gemma3|qwen|dlrm]
        [--out perf_iterations.json]

``--out`` writes the records through the port's ``results.write_record``.
No device is used.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys

from repro_torch.configs import registry
from repro_torch.configs.registry import ShapeSpec, get_arch
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.roofline import roofline_terms
from repro_torch.results import write_record

__all__ = ["run_variant", "variant", "CELLS", "main"]


@contextlib.contextmanager
def variant(arch_id: str, shape_name: str, cfg_update=None,
            dims_update=None):
    """The registry's ``arch_id`` with its config updated by
    ``cfg_update`` and its ``shape_name`` dims by ``dims_update``, inside
    the block (the original is restored after it)."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    if dims_update:
        shape = ShapeSpec(shape.name, shape.kind,
                          {**shape.dims, **dims_update}, shape.skip)

    def full_config(base=spec.full_config):
        cfg = base()
        return dataclasses.replace(cfg, **cfg_update) if cfg_update else cfg
    registry._REGISTRY[arch_id] = dataclasses.replace(
        spec, full_config=full_config,
        shapes=tuple(shape if s.name == shape_name else s
                     for s in spec.shapes))
    try:
        yield
    finally:
        registry._REGISTRY[arch_id] = spec


def run_variant(arch_id: str, shape_name: str, label: str, cfg_update=None,
                dims_update=None) -> dict:
    """One variant's dry-run record with its roofline ``terms`` (or
    ``built: False`` and the error), and its line printed."""
    with variant(arch_id, shape_name, cfg_update, dims_update):
        try:
            get_arch(arch_id).full_config()
        except ValueError as e:             # a config the port refuses
            rec = {"arch": arch_id, "shape": shape_name, "ok": False,
                   "builds": False, "why": str(e)}
        else:
            rec = run_cell(arch_id, shape_name, verbose=False)
    rec["label"] = label
    rec["cfg_update"] = cfg_update or {}
    rec["dims_update"] = dims_update or {}
    if rec.get("builds") is False or rec["ok"] is not True:
        rec["built"] = False
        rec.setdefault("why", rec.get("error"))
        print(f"  {label:34s} NOT BUILT: {rec['why']}")
        return rec
    rec["built"] = True
    t = rec["terms"] = roofline_terms(rec)
    ma = rec["memory_analysis"]
    print(f"  {label:34s} comp={t['compute_s']:8.3f}s "
          f"mem={t['memory_s']:8.3f}s coll={t['collective_s']:9.3f}s "
          f"[{t['bottleneck']:>10s}] useful={t['useful_ratio']:.2f} "
          f"temp={ma['temp_size_in_bytes'] / 1e9:.1f}GB "
          f"arg={ma['argument_size_in_bytes'] / 1e9:.1f}GB")
    return rec


def cell_kimi():
    print("\n=== kimi-k2-1t-a32b:train_4k (collective-bound) ===")
    return [
        run_variant("kimi-k2-1t-a32b", "train_4k",
                    "it0: gspmd scatter dispatch",
                    cfg_update={"moe_impl": "gspmd"}),
        run_variant("kimi-k2-1t-a32b", "train_4k",
                    "it1: shard_map local dispatch"),
        run_variant("kimi-k2-1t-a32b", "train_4k",
                    "it2: it1 + microbatches 8->4",
                    dims_update={"microbatches": 4}),
        run_variant("kimi-k2-1t-a32b", "train_4k",
                    "it3: it1 + microbatches 8->2",
                    dims_update={"microbatches": 2})]


def cell_gemma3():
    print("\n=== gemma3-12b:train_4k (TP all-reduce tax) ===")
    return [
        run_variant("gemma3-12b", "train_4k", "it0: TP16 mapping (baseline)"),
        run_variant("gemma3-12b", "train_4k", "it1: pure-DP mapping, micro=8",
                    dims_update={"mapping": "dp"}),
        run_variant("gemma3-12b", "train_4k", "it2: pure-DP mapping, micro=1",
                    dims_update={"mapping": "dp", "microbatches": 1}),
        run_variant("gemma3-12b", "train_4k", "it3: pure-DP mapping, micro=2",
                    dims_update={"mapping": "dp", "microbatches": 2})]


def cell_qwen():
    print("\n=== qwen1.5-32b:train_4k (generalizing the DP mapping) ===")
    return [
        run_variant("qwen1.5-32b", "train_4k",
                    "it0: TP16 mapping (baseline)"),
        run_variant("qwen1.5-32b", "train_4k",
                    "it1: FSDP-DP mapping, micro=1",
                    dims_update={"mapping": "dp", "microbatches": 1})]


def cell_dlrm():
    print("\n=== dlrm-mlperf:train_batch (the paper's technique) ===")
    return [
        run_variant("dlrm-mlperf", "train_batch",
                    "it0: full tables (188M rows)"),
        run_variant("dlrm-mlperf-baco", "train_batch",
                    "it1: BACO codebooks ratio 1/4"),
        run_variant("dlrm-mlperf-baco", "train_batch",
                    "it2: BACO codebooks ratio 1/8",
                    cfg_update={"etc_ratio": 0.125})]


CELLS = {"kimi": cell_kimi, "gemma3": cell_gemma3, "dlrm": cell_dlrm,
         "qwen": cell_qwen}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=None, choices=list(CELLS))
    ap.add_argument("--out", default="perf_iterations.json")
    args = ap.parse_args(argv)
    results = []
    for name, fn in CELLS.items():
        if args.cell and name != args.cell:
            continue
        results.extend(fn())
    write_record(args.out, [{k: v for k, v in r.items() if k != "traceback"}
                            for r in results])
    print(f"\nwrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

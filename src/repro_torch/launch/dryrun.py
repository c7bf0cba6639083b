"""Dry run: every cell's per-rank account on a production mesh (port of
``repro.launch.dryrun``).

The reference lowers and compiles each (architecture x input shape) cell
for the (16, 16) and (2, 16, 16) meshes on 512 host devices and records
what XLA reports. Torch has no compiler for a 512-device program, so the
port keeps the analytic half: for each cell it builds the cell's layouts
on a ``launch.mesh.AbstractMesh`` of (16, 16) or (2, 16, 16), with meta
tensors at the full published config (``launch.steps.cell_args``:
params, optimizer state, statics, the decode cache, the batch), opens no
world and touches no device, and records

  * the reference's keys ``arch``, ``shape``, ``kind``, ``mesh``
    ("16x16" / "2x16x16"), ``skip``, ``ok``, ``notes``, and ``error`` (with
    a ``traceback``) on a failure;
  * ``arg_bytes_per_device``: every argument leaf's block bytes, as the
    reference's ``_arg_bytes_per_device`` reckons them, on the port's own
    layouts; ``bytes``: the same by kind (params, opt_state, statics,
    cache, batch);
  * ``reference_layout_bytes``: the same on the reference's layouts (its
    ``_arg_bytes_per_device``, byte for byte), and a decode cell's
    ``reference_cache_bytes``: the port's own differ by design where a
    model axis does not divide the K/V heads (wk/wv/bk/bv whole over
    "model": ROADMAP Queue 3 #14) and in the decode cache (head-sharded
    where the reference's is sequence-sharded: Queue 3 #12);
  * ``builds``: whether ``build_cell(mesh=...)`` builds the cell on such a
    mesh (qwen1.5-32b's 40 query heads do not divide a model axis of 16:
    the port's attention needs whole heads a rank, and its account is
    the reference's layouts), with ``why`` where it does not;
  * ``fits``: whether the arguments alone stay within 85% of an H100
    80GB HBM3 (``H100_BYTES``); an LM's ``fsdp``, ``zero`` and
    ``optimizer``.

What it leaves out (ROADMAP Queue 1 #3c): the compiled program's
``memory_analysis`` (temporaries, outputs), ``cost_analysis`` and the
HLO metrics (dot FLOPs, HBM bytes and collective bytes a device). They
wait for the dry-run half of ``roofline.py`` / ``hlo_analysis.py``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--include-variants] [--out results.json]

Skipped cells are recorded as skipped; the last line is the reference's
summary, ``N ok / M skipped / K failed of T``, and the exit code is 1 if
any failed.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback

from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.obs import clock

__all__ = ["run_cell", "run", "main", "H100_BYTES", "FIT_SHARE"]

# an H100 80GB HBM3's memory as torch reports it
# (torch.cuda.get_device_properties(0).total_memory), and the share of it
# a cell may hold (chip_smoke.PEAK_SHARE)
H100_BYTES = 85_017_493_504
FIT_SHARE = 0.85


def production_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and names, with no devices."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def _notes(info: dict) -> str:
    if not info:
        return ""
    over = "every axis" if info["tag"] == "vocab" else "data"
    parts = [f"fsdp={info['fsdp']}",
             f"params {'ZeRO' if info['zero'] else 'replicated'} over "
             f"{over}"]
    if "optimizer" in info:
        parts.insert(0, f"optimizer={info['optimizer']}")
    return ",".join(parts)


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             verbose: bool = True) -> dict:
    """One cell's record on the production mesh (module docstring)."""
    spec = get_arch(arch_id)
    shape = spec.shape(shape_name)
    rec = {"arch": arch_id, "shape": shape_name, "kind": shape.kind,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "skip": shape.skip, "ok": False}
    if shape.skip is not None:
        rec["ok"] = "skipped"
        if verbose:
            print(f"[dryrun] {arch_id}:{shape_name} SKIPPED ({shape.skip})")
        return rec
    t0 = clock.now()
    mesh = production_mesh(multi_pod)
    try:
        ref = steps.arg_bytes(arch_id, shape_name, mesh, reference=True)
        rec["builds"] = True
        try:
            own = steps.arg_bytes(arch_id, shape_name, mesh)
        except ValueError as e:         # the port cannot split the heads
            rec["builds"], rec["why"] = False, str(e)
            own = dict(ref)
        info = own.pop("info")
        ref.pop("info")
        rec["arg_bytes_per_device"] = own["total"]
        rec["bytes"] = {k: v for k, v in own.items() if k != "total"}
        rec["reference_layout_bytes"] = ref["total"]
        if "cache" in ref:
            rec["reference_cache_bytes"] = ref["cache"]
        rec["fits"] = own["total"] <= FIT_SHARE * H100_BYTES
        rec.update({k: info[k] for k in ("fsdp", "zero", "optimizer")
                    if k in info})
        rec["notes"] = _notes(info)
        rec["seconds"] = clock.ms_between(t0, clock.now()) / 1e3
        rec["ok"] = True
        if verbose:
            print(f"[dryrun] {arch_id}:{shape_name} mesh={rec['mesh']} OK "
                  f"argGB/dev={own['total'] / 1e9:.3f} (reference layouts "
                  f"{ref['total'] / 1e9:.3f}) fits={rec['fits']}"
                  + ("" if rec["builds"] else f" builds=False ({rec['why']})"))
    except Exception as e:            # noqa: BLE001 - recorded, as the reference's
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch_id}:{shape_name} FAILED: {rec['error']}")
    return rec


def run(cells, meshes, verbose: bool = True) -> list:
    """The records of ``cells`` (arch, shape) on each mesh of ``meshes``
    (``multi_pod`` flags), mesh by mesh."""
    return [run_cell(a, s, multi_pod=mp, verbose=verbose)
            for mp in meshes for a, s in cells]


def summary(results: list) -> tuple:
    """(ok, skipped, failed) counts."""
    n_ok = sum(1 for r in results if r["ok"] is True)
    n_skip = sum(1 for r in results if r["ok"] == "skipped")
    return n_ok, n_skip, len(results) - n_ok - n_skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--include-variants", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells(include_skipped=True,
                          include_variants=args.include_variants)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = run(cells, meshes)
    n_ok, n_skip, n_fail = summary(results)
    print(f"\n[dryrun] {n_ok} ok / {n_skip} skipped / {n_fail} failed "
          f"of {len(results)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[dryrun] wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())

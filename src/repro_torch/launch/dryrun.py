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

The compiled half (on by default, as in the reference; ``--args-only``
keeps the arguments alone): torch has no compiler for a 512-device
program, so the port reckons one rank's step instead. It opens a fake
world of 256 or 512 ranks (``torch.distributed``'s "fake" backend: every
collective returns at once, and no data exists), builds the cell with
``build_cell(arch, shape, mesh=..., args=steps.cell_args(...))`` on meta
tensors at the full published config on the production mesh, runs its
``fn`` once under ``launch.op_analysis.OpAnalysis`` as rank ``--rank``
(default 0), and destroys the world. It raises if a world is already
open: a fake world must not leak into a process that has one. It records

  * ``op_metrics``: the reference's ``hlo_metrics`` keys (``dot_flops``
    by dtype, ``hbm_bytes``, ``coll_bytes/<kind>``, ``coll_bytes_total``),
    renamed because nothing here is HLO, with the op analysis's own
    (collective bytes by link, kernel calls and their operations, host
    reads, the branches its answers took);
  * ``memory_analysis``: ``argument_size_in_bytes``,
    ``output_size_in_bytes`` and ``temp_size_in_bytes`` (the peak of the
    live storages the step made, arguments left out), from the meta
    storages.
There is no ``cost_analysis``: XLA's counts each computation once, and an
eager torch step has no such once-per-computation count (the op
analysis counts every op as it runs). A cell that does not build on the
mesh (``builds: false``) gets no compiled half.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--include-variants] [--args-only] [--rank N] [--out results.json]

Skipped cells are recorded as skipped; the last line is the reference's
summary, ``N ok / M skipped / K failed of T``, and the exit code is 1 if
any failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import traceback

import torch.distributed as dist

from repro_torch.configs import all_cells, get_arch
from repro_torch.launch import op_analysis, steps
from repro_torch.launch.mesh import AbstractMesh, make_mesh
from repro_torch.models import lightgcn as LG
from repro_torch.obs import clock

__all__ = ["run_cell", "run", "main", "fake_world", "reckon",
           "H100_BYTES", "FIT_SHARE"]

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


def mesh_size(multi_pod: bool) -> int:
    """The ranks of the production mesh."""
    return 512 if multi_pod else 256


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``torch.distributed`` world of ``size`` ranks on the "fake"
    backend (no data moves; every collective returns at once), as rank
    ``rank``; destroyed on leaving. Raises if a world is already open."""
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed world is already open; the "
                           "dry run's fake world would replace it")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


_ARG_ORDER = ("params", "opt_state", "cache", "statics", "batch")


def _meta_args(arch_id: str, shape_name: str, mesh) -> tuple:
    """The unsharded cell's args at the full published config on meta
    tensors (``steps.cell_args``), in the cell's order; a cf cell's edges
    as the sorted-edge statics its step reads."""
    ca = steps.cell_args(arch_id, shape_name, mesh)
    spec = get_arch(arch_id)
    if spec.family in ("recsys", "cf") and "statics" not in ca:
        ca["statics"] = (None, {})            # an uncompressed arch's
    args = [ca[k][1] for k in _ARG_ORDER if k in ca]
    if spec.family == "cf":
        cfg = spec.full_config()
        statics = dict(args[-2])
        statics.update(LG.edge_statics_like(statics["edge_u"].shape[0],
                                            cfg.n_users, cfg.n_items))
        args[-2] = statics
    return tuple(args)


def reckon(arch_id: str, shape_name: str, mesh=None, device_mesh=None,
           **cuts) -> tuple:
    """(op metrics, memory analysis) of one rank's step of the cell,
    built on meta tensors and counted by ``op_analysis`` (module
    docstring). ``mesh``: an ``AbstractMesh``'s shape and names, the cell
    built from ``steps.cell_args`` at the full published config over
    ``device_mesh`` (the same mesh over the open world, made here when
    None). Without a mesh, the one-card cell of ``build_cell(arch, shape,
    **cuts)`` (``cuts``: ``steps.LM_ONE_CARD``'s), which opens no
    world."""
    if mesh is None:
        cell = steps.build_cell(arch_id, shape_name, device="meta", **cuts)
    else:
        if device_mesh is None:
            device_mesh = make_mesh(mesh.shape, mesh.mesh_dim_names, "cpu")
        cell = steps.build_cell(arch_id, shape_name, mesh=device_mesh,
                                args=_meta_args(arch_id, shape_name, mesh),
                                device="meta")
    _, metrics, memory = op_analysis.count(cell.fn, *cell.args)
    return metrics, memory


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
             verbose: bool = True, args_only: bool = False, rank: int = 0,
             device_mesh=None) -> dict:
    """One cell's record on the production mesh (module docstring).
    ``device_mesh``: the production mesh over a fake world the caller
    opened (:func:`run` opens one a mesh); without it the compiled half
    opens its own, as rank ``rank``."""
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
        if rec["builds"] and not args_only:
            with (contextlib.nullcontext() if device_mesh is not None else
                  fake_world(mesh_size(multi_pod), rank)):
                rec["op_metrics"], rec["memory_analysis"] = reckon(
                    arch_id, shape_name, mesh, device_mesh)
            rec["rank"] = rank if device_mesh is None else dist.get_rank()
        rec["seconds"] = clock.ms_between(t0, clock.now()) / 1e3
        rec["ok"] = True
        if verbose:
            print(f"[dryrun] {arch_id}:{shape_name} mesh={rec['mesh']} OK "
                  f"argGB/dev={own['total'] / 1e9:.3f} (reference layouts "
                  f"{ref['total'] / 1e9:.3f}) fits={rec['fits']}"
                  + ("" if rec["builds"] else f" builds=False ({rec['why']})"))
            if "op_metrics" in rec:
                om, ma = rec["op_metrics"], rec["memory_analysis"]
                print(f"  dotTF/dev={om['dot_flops'] / 1e12:.3f} "
                      f"hbmGB/dev={om['hbm_bytes'] / 1e9:.3f} "
                      f"collGB/dev={om['coll_bytes_total'] / 1e9:.3f} "
                      f"tempGB/dev={ma['temp_size_in_bytes'] / 1e9:.3f} "
                      f"kernels={om['kernels']}")
    except Exception as e:            # noqa: BLE001 - recorded, as the reference's
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch_id}:{shape_name} FAILED: {rec['error']}")
    return rec


def run(cells, meshes, verbose: bool = True, args_only: bool = False,
        rank: int = 0) -> list:
    """The records of ``cells`` (arch, shape) on each mesh of ``meshes``
    (``multi_pod`` flags), mesh by mesh, each mesh's compiled halves over
    one fake world (as rank ``rank``)."""
    out = []
    for mp in meshes:
        world = (contextlib.nullcontext() if args_only else
                 fake_world(mesh_size(mp), rank))
        with world:
            dm = None
            if not args_only:
                am = production_mesh(mp)
                dm = make_mesh(am.shape, am.mesh_dim_names, "cpu")
            out += [run_cell(a, s, multi_pod=mp, verbose=verbose,
                             args_only=args_only, device_mesh=dm)
                    for a, s in cells]
    return out


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
    ap.add_argument("--args-only", action="store_true",
                    help="the arguments' bytes alone, without the compiled "
                         "half (op metrics, memory analysis)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step the compiled half reckons")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells(include_skipped=True,
                          include_variants=args.include_variants)
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = run(cells, meshes, args_only=args.args_only, rank=args.rank)
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

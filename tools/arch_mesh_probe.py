#!/usr/bin/env python3
"""Where a recsys cell's time goes on a mesh of one NVIDIA GPU: the
row-sharded lookup's id checks against its collectives.

    python3 tools/arch_mesh_probe.py [--rounds 8]

(``--device cpu --smoke --rounds 1`` rehearses it on the CPU at the
smoke configs, on a gloo world of 1, without the profile.)

On an NCCL world of 1 (``make_host_mesh``) it builds, at full published
width, dlrm-mlperf-baco serve_p99 and wide-deep-baco train_batch
through ``build_cell(mesh=...)`` beside their one-card twins (the mesh
cell from the twin's args), then times one call (a train cell: one
step) of five variants, in turn, ``--rounds`` times after one warm-up
each
variant:

* ``twin``: the one-card cell;
* ``mesh``: the mesh cell as it is;
* ``no_id_check``: the mesh cell with ``models.recsys._check_ids`` (one
  blocking host read a lookup) made a no-op;
* ``no_collectives``: the mesh cell with ``parallel.all_reduce`` and
  ``parallel.all_gather_cat`` made the identity, which on a world of 1
  they are in value (each group holds this rank alone); a collective
  over a group of one rank now returns at once without being issued, so
  on a world of 1 this variant is ``mesh``;
* ``neither``: both.

Every variant's output (a train cell's loss and gradients, before any
step) must equal the twin's bitwise; the timed steps then update each
cell's params in place. Then one call of ``twin`` and of ``mesh`` runs under
``torch.profiler``: device busy ms (kernels only), wall ms, and the host
ops with the most self CPU time. Prints a summary, one
``arch_mesh_probe`` JSON line with every reading, and the card's name
and power limit. Times are host clock readings
(``repro_torch.obs.clock``) around a call that ends in a synchronize.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

CELLS = (("dlrm-mlperf-baco", "serve_p99"), ("wide-deep-baco", "train_batch"))
VARIANTS = ("twin", "mesh", "no_id_check", "no_collectives", "neither")


@contextlib.contextmanager
def patched(variant: str):
    """The variant's stand-ins for the id check and the collectives."""
    from repro_torch.distributed import parallel as par
    from repro_torch.models import recsys as R

    saved = (R._check_ids, par.all_reduce, par.all_gather_cat)
    if variant in ("no_id_check", "neither"):
        R._check_ids = lambda ids, n_rows: None
    if variant in ("no_collectives", "neither"):
        par.all_reduce = lambda t, group, op=None: t
        par.all_gather_cat = lambda t, group, dim: t
    try:
        yield
    finally:
        R._check_ids, par.all_reduce, par.all_gather_cat = saved


def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def result(cell):
    """A serve cell's output; a train cell's loss and gradients, without
    the step's update (which is in place)."""
    if cell.kind == "train":
        return cell.fn.value_and_grad(cell.args[0], cell.args[-2],
                                      cell.args[-1])
    return cell.fn(*cell.args)


def same(a, b) -> bool:
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return torch.equal(a[0], b[0]) and a[1].keys() == b[1].keys() and all(
        torch.equal(v, b[1][k]) for k, v in a[1].items())


def profiled(fn, args) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import clock

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = clock.now()
        fn(*args)
        torch.cuda.synchronize()
        wall = clock.ms_between(t, clock.now())
    busy, host = 0.0, {}
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0.0))
        if (dev > 0 and e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith(("aten::", "cuda"))):
            busy += dev / 1e3
        if e.self_cpu_time_total > 0:
            host[e.key[:60]] = (e.self_cpu_time_total / 1e3, e.count)
    top = sorted(host.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "host_self_ms_top": {k: {"ms": v[0], "count": v[1]}
                                 for k, v in top}}


def probe_cell(mesh, arch: str, shape: str, rounds: int, device: str,
               smoke: bool) -> dict:
    import gc

    import torch

    from repro_torch.launch.steps import build_cell
    from repro_torch.obs import clock

    one = build_cell(arch, shape, smoke=smoke, device=device)
    args = one.args
    if one.kind == "train":
        args = (clone(one.args[0]), None) + tuple(one.args[2:])
    cell = build_cell(arch, shape, mesh=mesh, smoke=smoke, device=device,
                      args=args)
    want = result(one)
    runs = {v: (one if v == "twin" else cell) for v in VARIANTS}
    for v, c in runs.items():
        with patched(v):
            if not same(result(c), want):
                raise SystemExit(f"{arch}:{shape} {v}: not bitwise the twin")
    ms = {v: [] for v in VARIANTS}
    for _ in range(rounds):
        for v, c in runs.items():
            with patched(v):
                sync(device)
                t = clock.now()
                c.fn(*c.args)
                sync(device)
                ms[v].append(clock.ms_between(t, clock.now()))
    res = {"cell": f"{arch}:{shape}", "rounds": rounds, "ms": ms,
           "ms_median": {v: statistics.median(x) for v, x in ms.items()},
           "profile": {}}
    if device == "cuda":
        res["profile"] = {"twin": profiled(one.fn, one.args),
                          "mesh": profiled(cell.fn, cell.args)}
    del one, cell, args, want, runs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    a = ap.parse_args(argv)

    import torch

    from repro_torch.distributed import world
    from repro_torch.kernels import platform
    from repro_torch.launch.mesh import make_host_mesh

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        platform.build()
    with world(a.device):
        mesh = make_host_mesh(a.device)
        res = [probe_cell(mesh, arch, shape, a.rounds, a.device, a.smoke)
               for arch, shape in CELLS]
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    for r in res:
        print(r["cell"], json.dumps(r["ms_median"]))
        for k, p in r["profile"].items():
            print(f"  {k}: wall {p['wall_ms']:.3f} ms, device busy "
                  f"{p['device_busy_ms']:.3f} ms")
            for name, v in list(p["host_self_ms_top"].items())[:8]:
                print(f"    {v['ms']:9.3f} ms x{v['count']:<5} {name}")
    print(json.dumps({"arch_mesh_probe": res}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Holds the port's fused top-k kernel bitwise against another build of
its source on one NVIDIA GPU, times both builds in one call, and splits
this build's device time between its kernels (a check made once, when
the kernel is rewritten).

    git show <commit>:src/repro_torch/kernels/csrc/fused_topk.cu \\
        > build/parent/fused_topk.cu
    python3 tools/fused_topk_parity.py build/parent/fused_topk.cu

The other source must have the C interface of ``fused_topk_launch``,
``fused_topk_codebook_launch`` and ``fused_topk_tiling``, with or without
the bounds scratch argument (read from the source: a ``fused_topk_launch``
that takes ``uint64_t* bounds``). It is called with the chunks of the
earlier plan rule, ceil(slots / groups) chunks a group of 64 rows (see
:func:`other_chunk`), from its own tiling report. The inputs are
``chip_smoke.py``'s: the amazonbook main path's propagated embeddings.

- dense (``plan``): B 1, 8, 64, 512 at k 20, 33, 64, 100, 128 with the
  item mask, each timed in turns (other, this, this, other) beside
  ``torch.topk(u @ v.T + mask, k)`` and the operations' bound; at B 1
  and 512 each build's device time split by torch.profiler between its
  kernels (``score_chunks``, ``merge_chunks``, the bounds' ``Memset``);
- int8: the item rows quantized per row, B 64 and 512 at k 20-128;
- codebook: the embedding phase's 48 readout cases at k 20, and at B 64
  and 512 at k 33-128;
- ``sweep``: this build at B 1, 8, 64, 128 and k 33-128 in chunks of
  ``SWEEP_CHUNKS`` items and the plan's own, with the rows' shared
  bounds forced on and off (``fused_topk._SHARE_WORK``), each result
  bitwise the other build's at the same chunk, each timed: the readings
  behind ``plan_chunk`` and ``shares_bounds``;
- ``repeats``: B 64, k 33 in 704-item chunks, ``REPEATS`` calls with the
  bounds on and as many off, each bitwise the other build's.

Prints one JSON line with the counts of bitwise-equal results (values
and ids); exits non-zero unless every case is equal.
"""
from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)
import parity_build  # noqa: E402

K_LONG = (33, 64, 100, 128)
SWEEP_BATCHES = (1, 8, 64, 128)
SWEEP_CHUNKS = (384, 704, 768, 1024)
REPEATS = 200


def bind(path: str, bounds: bool) -> dict:
    """The C entry points of the library at ``path``; ``bounds``: its
    launches take the bounds scratch argument."""
    tail = [ctypes.c_void_p] * (6 if bounds else 5)
    out = {"dense": parity_build.entry(
               path, "fused_topk_launch",
               [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + tail),
           "codebook": parity_build.entry(
               path, "fused_topk_codebook_launch",
               [ctypes.c_void_p] * 4 + [ctypes.c_int]
               + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + tail),
           "tiling": parity_build.entry(
               path, "fused_topk_tiling",
               [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3),
           "bounds": bounds}
    return out


def takes_bounds(src: str) -> bool:
    """Whether the source's ``fused_topk_launch`` takes the bounds
    scratch."""
    with open(src) as f:
        text = f.read()
    head = text[text.index('extern "C" int fused_topk_launch('):]
    return "uint64_t* bounds" in head[:head.index(")")]


@contextlib.contextmanager
def shared_bounds(on: bool):
    """This build's calls with the rows' shared bounds forced on or off
    (at k 33-128), whatever the batch."""
    mod = importlib.import_module("repro_torch.kernels.fused_topk")
    was = mod._SHARE_WORK
    mod._SHARE_WORK = 0 if on else 1 << 62
    try:
        yield
    finally:
        mod._SHARE_WORK = was


def profile_split(fn, calls: int = 5) -> dict:
    """{kernel: device ms a call} of ``fn``, from torch.profiler's CUDA
    activity over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us <= 0:
            continue
        key = next((p for p in ("score_chunks", "merge_chunks", "Memset")
                    if p in ev.key), ev.key[:40])
        split[key] = split.get(key, 0.0) + us / 1e3 / calls
    return split


def other_chunk(other: dict, rows: int, n: int, d: int, codebook: bool,
                quantized: bool, k: int) -> int:
    """The chunk of the earlier plan rule for the other build: its tiling
    report, ceil(slots / groups) chunks a group, whole tiles, at least
    256 items."""
    import torch
    res = [ctypes.c_int() for _ in range(3)]
    status = other["tiling"](d, int(codebook), int(quantized), k,
                             *map(ctypes.byref, res))
    if status != 0:
        raise RuntimeError(f"the other build's tiling failed: {status}")
    per_block, per_tile, per_sm = (r.value for r in res)
    slots = per_sm * torch.cuda.get_device_properties(0).multi_processor_count
    groups = max(1, -(-rows // per_block))
    want = max(1, -(-slots // groups))
    chunk = -(-n // want)
    return max(256, -(-chunk // per_tile) * per_tile)


def this_chunk(rows: int, n: int, d: int, k: int) -> int:
    """The chunk this build's plan gives a dense f32 call."""
    import torch

    from repro_torch.kernels.fused_topk import _tiling, plan_chunk
    per_block, per_tile, slots = _tiling(torch.device("cuda"), d, False,
                                         False, k)
    return plan_chunk(rows, n, rows_per_block=per_block,
                      items_per_tile=per_tile, slots=slots, k=k)


def run(other, variant, lead, u, k, n, scale, mask, exclude, chunk):
    """One call of the other build's ``variant`` entry point, with its
    outputs and scratch."""
    import torch

    from repro_torch.kernels.fused_topk import exclusion_csr

    dev, rows = u.device, u.shape[0]
    ex_ptr = ex_ids = None
    if exclude is not None and len(exclude[0]):
        ex_ptr, ex_ids = exclusion_csr(exclude, rows, n, dev)
    n_chunks = -(-n // chunk)
    part_v = torch.empty(rows, n_chunks, k, device=dev)
    part_i = torch.empty(rows, n_chunks, k, dtype=torch.int32, device=dev)
    out_v = torch.empty(rows, k, device=dev)
    out_i = torch.empty(rows, k, dtype=torch.int32, device=dev)
    scratch = [part_v, part_i]
    if other["bounds"]:
        scratch.append(None)
    args = [u.contiguous(), *lead, mask, ex_ptr, ex_ids]

    def arg(a):
        return a.data_ptr() if isinstance(a, torch.Tensor) else a

    status = other[variant](
        *map(arg, args), rows, n, u.shape[1], k, chunk,
        int(scale is not None), *map(arg, scratch), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"the other build's launch failed: {status}")
    return out_v, out_i


def main(src: str) -> int:
    import torch

    from repro_torch.embedding import dequantize_params, quantize_int8_rows
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import fused_topk
    from repro_torch.models import lightgcn as L

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    other = bind(parity_build.build(src, "fused_topk_other"),
                 takes_bounds(src))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        main_run = chip_smoke.main_path(wd)
    dev = torch.device("cuda")
    loaded = main_run["loaded"]
    params = {kk: torch.as_tensor(vv, device=dev)
              for kk, vv in loaded.params.items()}
    statics = loaded.statics(dev)
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    loaded.mcfg())
    v_all = v_all.contiguous()
    q, scale = (torch.as_tensor(a, device=dev)
                for a in quantize_int8_rows(v_all.cpu().numpy()))
    mask = statics.get("item_mask")
    n, d = v_all.shape
    plus = mask if mask is not None else torch.zeros(n, device=dev)
    t = chip_smoke.time_ms
    counts = {name: {"cases": 0, "bitwise": 0}
              for name in ("dense", "int8", "codebook")}
    counts.update({name: {"cases": 0, "bitwise": 0}
                   for name in ("sweep", "repeats")})
    unequal, times, split, sweep = [], {}, {}, {}

    def same(a, o):
        return bool(torch.equal(a[0].nan_to_num(), o[0].nan_to_num())
                    and torch.equal(a[0].isnan(), o[0].isnan())
                    and torch.equal(a[1], o[1]))

    def tally(name, what, a, o):
        ok = same(a, o)
        counts[name]["cases"] += 1
        counts[name]["bitwise"] += ok
        if not ok:
            unequal.append(f"{name} {what}")

    def case(name, what, ours, theirs, timed):
        tally(name, what, ours(), theirs())
        if timed:
            row = {"other_ms": [t(theirs)]}
            row["ms"] = [t(ours) for _ in range(2)]
            row["other_ms"].append(t(theirs))
            times[f"{name} {what}"] = row
        return times.get(f"{name} {what}")

    for k in (20,) + K_LONG:
        for b in (1, 8, 64, 512):
            u = u_all[:b].contiguous()
            chunk = other_chunk(other, b, n, d, False, False, k)

            def ours():
                return fused_topk(u, v_all, k, mask=mask)

            def theirs():
                return run(other, "dense", (v_all, None), u, k, n, None,
                           mask, None, chunk)

            row = case("dense", f"B={b} k={k}", ours, theirs, timed=True)
            row["library_ms"] = t(lambda: torch.topk(u @ v_all.T + plus, k))
            row["bound_ms"] = kcost.bound(kcost.fused_topk(
                u, v_all, k, mask=mask))[0]
            if b in (1, 512):
                split[f"B={b} k={k}"] = {"this": profile_split(ours),
                                         "other": profile_split(theirs)}
    for b in (64, 512):
        u = u_all[:b].contiguous()
        for k in (20,) + K_LONG:
            chunk = other_chunk(other, b, n, d, False, True, k)
            case("int8", f"B={b} k={k}",
                 lambda: fused_topk(u, q, k, scale=scale, mask=mask),
                 lambda: run(other, "dense", (q, scale), u, k, n, scale,
                             mask, None, chunk),
                 timed=b == 512 and k in (20, 100))
    emb = chip_smoke.embedding_inputs(main_run, "cuda")
    for side in ("items", "users"):
        for b in (1, 8, 64, 512):
            for k in (20,) + (K_LONG if b in (64, 512) else ()):
                for i, (u, kw) in enumerate(
                        chip_smoke.readout_cases(emb, side, b, "cuda")):
                    items, sk = kw.pop("items"), kw.pop("sketch")
                    sc = kw.get("scale")
                    ns = int(sk.shape[0])
                    chunk = other_chunk(other, b, ns, d, True,
                                        sc is not None, k)
                    case("codebook", f"{side} B={b} k={k} case {i}",
                         lambda: fused_topk(u, items, k, sketch=sk, **kw),
                         lambda: run(other, "codebook",
                                     (items, sc, sk, int(sk.shape[1])), u, k,
                                     ns, sc, kw.get("mask"),
                                     kw.get("exclude"), chunk),
                         timed=b == 512 and i == 0 and k in (20, 100))
    for k in K_LONG:
        for b in SWEEP_BATCHES:
            u = u_all[:b].contiguous()
            row = {}
            for chunk in SWEEP_CHUNKS + (None,):
                at = chunk or this_chunk(b, n, d, k)
                want = run(other, "dense", (v_all, None), u, k, n, None,
                           mask, None, at)
                for on in (False, True):
                    with shared_bounds(on):
                        def ours():
                            return fused_topk(u, v_all, k, mask=mask,
                                              block=at)
                        name = f"c{at}{' plan' if chunk is None else ''}"
                        name += " shared" if on else ""
                        tally("sweep", f"B={b} k={k} {name}", ours(), want)
                        row[name] = t(ours)
            sweep[f"B={b} k={k}"] = row
    u = u_all[:64].contiguous()
    want = run(other, "dense", (v_all, None), u, 33, n, None, mask, None, 704)
    for on in (False, True):
        with shared_bounds(on):
            for i in range(REPEATS):
                tally("repeats", f"B=64 k=33 c704 shared={on} #{i}",
                      fused_topk(u, v_all, 33, mask=mask, block=704), want)
    result = {"source": src, "counts": counts, "unequal": unequal[:20],
              "times": times, "profile": split, "sweep": sweep,
              "timer_floor_ms": chip_smoke.timer_floor_ms(),
              "gpu": chip_smoke.gpu_line()}
    print(json.dumps({"topk_parity": result}))
    return 0 if not unequal else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))

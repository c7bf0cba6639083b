#!/usr/bin/env python3
"""Holds the port's two gather kernels, the CSR gather-sum
(``embedding_bag.cu``) and ``codebook_lookup.cu``, bitwise against
another build of their sources on one NVIDIA GPU, and times both builds
in one call (a check made when the kernels are rewritten).

    mkdir -p build/parent
    for k in embedding_bag codebook_lookup; do
      git show <commit>:src/repro_torch/kernels/csrc/$k.cu > build/parent/$k.cu
    done
    python3 tools/gather_parity.py build/parent

The other sources must have the same C interfaces
(``csr_gather_sum_launch``, ``codebook_lookup_launch``). Both builds fold
every output column with __fadd_rn in value order from +0.0f, so they
must agree bit for bit on any input. The cases:

- the embedding path's shapes, as ``chip_smoke.csr_cases`` builds them
  from the amazonbook train split and the GPU sketch: the bag forward
  (547,067 values in 52,643 bags), the bag backward (into 91,599 item
  rows) and the codebook gradients (into K_u and K_v rows); and
  codebook_lookup on both sides (binary Y); and the kernel bench's
  bags (``kernel/embedding_bag``: 65,536 values in 8,192 sorted random
  bags over a [200,000, 128] table);
- bags of one length each (``synthetic_inputs``), timed too: one row
  of 100,000 values, 132 rows of 20,000 (the long-row blocks), 52,643
  rows of 0, 1, 4, 16 (the short-row warps);
- the ``cuda`` tests' shapes: skewed bags (``chip_smoke.skewed_csr``) at
  d 1, 3, 50, 64, 128, 129 and 256, aligned and 4 bytes off, no values,
  no rows; codebook_lookup at d 1, 3, 50, 64, 129, 256 x H 1, 2, 3, 5,
  binary on and off, aligned and not, B 1,001 and 0.

The path shapes are timed with ``chip_smoke.time_ms`` (L2 flushed, a
device spin before the start event) in turns: plain version, other
build, this build, this build, other build. Prints one JSON line; exits
non-zero unless every case is equal.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)
import parity_build  # noqa: E402

NAMES = ("embedding_bag", "codebook_lookup")
BAG_DS = (1, 3, 50, 64, 128, 129, 256)
LOOKUP_DS = (1, 3, 50, 64, 129, 256)
LOOKUP_HS = (1, 2, 3, 5)


def bind(path: str):
    """(csr_gather_sum, codebook_lookup) callables of the libraries
    ``path % name``, each allocating its output like the wrappers."""
    import torch

    bag = parity_build.entry(
        path % "embedding_bag", "csr_gather_sum_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p])
    cb = parity_build.entry(
        path % "codebook_lookup", "codebook_lookup_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])

    def gather_sum(src, idx, ptr):
        rows = ptr.numel() - 1
        out = torch.empty(rows, src.shape[1], device=src.device)
        status = bag(src.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
                     out.data_ptr(), rows, src.shape[1],
                     torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{path % 'embedding_bag'}: launch {status}")
        return out

    def lookup(z, ix, binary):
        out = torch.empty(ix.shape[0], z.shape[1], device=z.device)
        status = cb(z.data_ptr(), ix.data_ptr(), out.data_ptr(),
                    ix.shape[0], ix.shape[1], z.shape[1], int(binary),
                    torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{path % 'codebook_lookup'}: launch "
                               f"{status}")
        return out

    return gather_sum, lookup


def path_inputs():
    """The embedding path's gather inputs: ``chip_smoke.csr_cases`` over
    the amazonbook train split, the GPU sketch and seeded tables, the
    kernel bench's bags, and codebook_lookup's (codebook, sketch) of
    both sides."""
    import torch

    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset

    _, _, _, train, _ = paperlike_dataset("amazonbook", seed=0)
    sketch = ClusterEngine(device="cuda").build(train, d=64, ratio=0.25)
    g = torch.Generator(device="cpu").manual_seed(17)
    emb = {"values": torch.as_tensor(train.edge_v, dtype=torch.int32,
                                     device="cuda"),
           "segments": torch.as_tensor(train.edge_u, dtype=torch.int64,
                                       device="cuda"),
           "n_users": train.n_users, "n_items": train.n_items}
    for side, idx, k in (("users", sketch.user_idx, sketch.k_users),
                         ("items", sketch.item_idx, sketch.k_items)):
        emb[side] = {"sketch": torch.as_tensor(idx, dtype=torch.int32,
                                               device="cuda"),
                     "z": torch.randn(k, 64, generator=g).cuda()}
    table = torch.randn(train.n_items, 64, generator=g).cuda()
    bags = chip_smoke.csr_cases(emb, table)
    # the kernel bench's bags (launch/kernel_bench.py, full size)
    segs = torch.sort(torch.randint(0, 8192, (65536,), generator=g)).values
    bags["kernel bench"] = (
        torch.randn(200000, 128, generator=g).cuda(),
        torch.randint(0, 200000, (65536,), generator=g,
                      dtype=torch.int32).cuda(),
        chip_smoke.csr_ptr(segs.cuda(), 8192))
    lookups = {side: (emb[side]["z"], emb[side]["sketch"])
               for side in ("users", "items")}
    return bags, lookups


def synthetic_inputs():
    """Bags of one length each over the forward's table shape, to
    separate the kernel's two paths: one row of 100,000 values (one
    block's streaming rate), 132 rows of 20,000 (a row per SM), and
    52,643 rows of 0, 1, 4 and 16 values (the short-row warps)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(29)
    table = torch.randn(91599, 64, generator=g).cuda()
    out = {}
    for rows, n in ((1, 100000), (132, 20000), (52643, 0), (52643, 1),
                    (52643, 4), (52643, 16)):
        ptr = torch.arange(rows + 1, dtype=torch.int64) * n
        idx = torch.randint(0, 91599, (rows * n,), generator=g,
                            dtype=torch.int32)
        out[f"{rows} rows x {n}"] = (table, idx.cuda(), ptr.cuda())
    return out


def edge_inputs():
    """The ``cuda`` tests' shapes: (name, src, idx, ptr) bags and (name,
    z, ix, binary) lookups."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(23)
    bags, lookups = [], []
    for d in BAG_DS:
        idx, ptr = chip_smoke.skewed_csr(5000, 1000, g, dev)
        flat = torch.randn(1000 * d + 1, generator=g).to(dev)
        for off in (0, 1):
            bags.append((f"skewed d={d} off={off}",
                         flat[off:off + 1000 * d].view(1000, d), idx, ptr))
    src = torch.randn(10, 64, device=dev)
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    bags.append(("no values", src, none,
                 torch.zeros(9, dtype=torch.int64, device=dev)))
    bags.append(("no rows", src, none,
                 torch.zeros(1, dtype=torch.int64, device=dev)))
    for d in LOOKUP_DS:
        flat = torch.randn(501 * d + 1, generator=g).to(dev)
        for h in LOOKUP_HS:
            ix = torch.randint(0, 501, (1001, h), generator=g,
                               dtype=torch.int32)
            if h > 1:
                ix[::2, -1] = ix[::2, 0]
            ix = ix.to(dev)
            for off in (0, 1):
                z = flat[off:off + 501 * d].view(501, d)
                for binary in (False, True):
                    lookups.append((f"d={d} H={h} off={off} "
                                    f"binary={binary}", z, ix, binary))
    lookups.append(("B=0", flat[:501 * d].view(501, d), ix[:0], True))
    return bags, lookups


def main(other_dir: str) -> int:
    import torch

    from repro_torch.kernels import codebook_lookup, csr_gather_sum, ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import platform
    started = [parity_build.start(os.path.join(other_dir, f"{n}.cu"),
                                  f"{n}_other") for n in NAMES]
    platform.build(NAMES)
    parity_build.finish(*started)
    old_bag, old_lookup = bind(
        os.path.join(parity_build.OUT_DIR, "lib%s_other.so"))

    bags, lookups = path_inputs()
    synthetic = synthetic_inputs()
    edge_bags, edge_lookups = edge_inputs()
    counts = {n: {"cases": 0, "bitwise": 0} for n in NAMES}
    unequal = []

    def tally(name, what, *results):
        same = all(torch.equal(results[0], r) for r in results[1:])
        counts[name]["cases"] += 1
        counts[name]["bitwise"] += bool(same)
        if not same:
            unequal.append(f"{name} {what}")

    for what, (src, idx, ptr) in bags.items():
        tally("embedding_bag", what, csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr), ref.csr_gather_sum(src, idx, ptr))
    for what, src, idx, ptr in edge_bags:
        tally("embedding_bag", what, csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr))
    for what, (src, idx, ptr) in synthetic.items():
        tally("embedding_bag", what, csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr))
    for side, (z, ix) in lookups.items():
        tally("codebook_lookup", side, codebook_lookup(z, ix, binary=True),
              old_lookup(z, ix, True), ref.codebook_lookup(z, ix, True))
    for what, z, ix, binary in edge_lookups:
        tally("codebook_lookup", what, codebook_lookup(z, ix, binary=binary),
              old_lookup(z, ix, binary))

    t = chip_smoke.time_ms
    times = {}
    for what, (src, idx, ptr) in bags.items():
        row = {"plain_ms": t(lambda: ref.csr_gather_sum(src, idx, ptr),
                             iters=5)}
        row["old_ms"] = [t(lambda: old_bag(src, idx, ptr))]
        row["new_ms"] = [t(lambda: csr_gather_sum(src, idx, ptr))
                         for _ in range(2)]
        row["old_ms"].append(t(lambda: old_bag(src, idx, ptr)))
        times[f"embedding_bag {what}"] = row
    for what, (src, idx, ptr) in synthetic.items():
        row = {"old_ms": t(lambda: old_bag(src, idx, ptr)),
               "new_ms": t(lambda: csr_gather_sum(src, idx, ptr))}
        times[f"embedding_bag synthetic {what}"] = row
    for side, (z, ix) in lookups.items():
        row = {"plain_ms": t(lambda: ref.codebook_lookup(z, ix, True))}
        row["old_ms"] = [t(lambda: old_lookup(z, ix, True))]
        row["new_ms"] = [t(lambda: codebook_lookup(z, ix, binary=True))
                         for _ in range(2)]
        row["old_ms"].append(t(lambda: old_lookup(z, ix, True)))
        times[f"codebook_lookup {side}"] = row
    print(json.dumps({"gather_parity": {
        "other": other_dir, "counts": counts,
        "unequal": unequal[:20], "times": times,
        "timer_floor_ms": chip_smoke.timer_floor_ms(),
        "gpu": chip_smoke.gpu_line()}}))
    return 0 if not unequal else 1


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1].startswith("-"):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))

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

(Copy the commit's ``gather.cuh`` and ``f32_convert.cuh`` there too: a
source's own directory is searched for its headers first.) The other
sources must have the same C interfaces (``csr_gather_sum_launch``,
``csr_gather_sum_weighted_launch``, ``csr_gather_sum16_launch``,
``codebook_lookup_launch``). Both
builds fold every output column with __fadd_rn in value order from
+0.0f, so they must agree bit for bit on any input. The cases:

- the embedding path's shapes, as ``chip_smoke.csr_cases`` builds them
  from the amazonbook train split and the GPU sketch: the bag forward
  (547,067 values in 52,643 bags), the bag backward (into 91,599 item
  rows) and the codebook gradients (into K_u and K_v rows); and
  codebook_lookup on both sides (binary Y); and the kernel bench's
  bags (``kernel/embedding_bag``: 65,536 values in 8,192 sorted random
  bags over a [200,000, 128] table);
- the other gather-sums of the port's paths (``more_inputs``), timed:
  the weighted LightGCN propagation of both sides (547,067 edges,
  ``csr_gather_sum_weighted_launch``), the ordered W(k) sum (800,000
  weights into 1,000,000 labels, d 1), SASRec's item-table backward
  (3,211,264 values into 250,112 rows, d 50), Wide&Deep's wide table
  (65,536 values into 250,112 rows, d 1) and SchNet's segment sums at
  ogb_products' (1/8 of its edges) and minibatch_lg's sizes;
- the 16-bit instantiation (``csr_gather_sum16_launch``) against the
  other build and its plain version: bf16 and f16 at the ``cuda`` tests'
  shapes, the LM token embedding's gradient (a Zipf-skewed draw of
  4,096 token ids over 256,000 rows, d 3,584, one microbatch of
  gemma2-9b's train_4k) and the MoE token combines (``MOE_SHAPES``:
  dbrx-132b's and kimi-k2's decode and prefill, dbrx-132b's train
  microbatch), timed in turns beside ``index_add_`` in f32;
- few wide rows (``wide_inputs``), bf16 and f32 at d 1,000 to 7,168:
  1, 8 and 64 rows of 0-40 values, one long row among them;
- bags of one length each (``synthetic_inputs``), timed too: one row
  of 100,000 values, 132 rows of 20,000 (the long-row blocks), 52,643
  rows of 0, 1, 4, 16 (the short-row warps);
- the ``cuda`` tests' shapes: skewed bags (``chip_smoke.skewed_csr``) at
  d 1, 3, 50, 64, 128, 129 and 256, aligned and 4 bytes off, no values,
  no rows; codebook_lookup at d 1, 3, 50, 64, 129, 256 x H 1, 2, 3, 5,
  binary on and off, aligned and not, B 1,001 and 0, in f32 and bf16;
- the 16-bit codebook_lookup (``codebook_lookup16_launch``) at the LM
  token lookups' shapes (``LM_SHAPES``: seeded bf16 tables, B uniform
  token ids, a -0.0 row and a NaN row among them), against the other
  build and the plain version word for word, timed beside ``table[ids]``,
  both also with the L2 flushed by reads (``time_clean_ms``).

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
# (what, B, K, d) of the LM token lookups: decode, train microbatch, prefill
LM_SHAPES = (("gemma2-9b decode", 4, 256_000, 3584),
             ("gemma3-12b decode", 8, 262_144, 3840),
             ("qwen1.5-32b decode", 2, 152_064, 5120),
             ("dbrx-132b decode", 8, 100_352, 6144),
             ("kimi-k2 decode", 64, 163_840, 7168),
             ("gemma3-12b train microbatch", 4096, 262_144, 3840),
             ("qwen1.5-32b train microbatch", 4096, 152_064, 5120),
             ("gemma2-9b prefill", 32768, 256_000, 3584),
             ("gemma3-12b prefill", 32768, 262_144, 3840),
             ("qwen1.5-32b prefill", 32768, 152_064, 5120),
             ("dbrx-132b prefill", 32768, 100_352, 6144),
             ("kimi-k2 prefill", 32768, 163_840, 7168))
BAG_DS = (1, 3, 50, 64, 128, 129, 256)
LOOKUP_DS = (1, 3, 50, 64, 129, 256)
LOOKUP_HS = (1, 2, 3, 5)


def bind(path: str):
    """(csr_gather_sum, codebook_lookup) callables of the libraries
    ``path % name``, each allocating its output like the wrappers; the
    gather-sum takes f32 (plain or weighted), bf16 and f16 rows."""
    import torch

    from repro_torch.kernels import platform

    bag = parity_build.entry(
        path % "embedding_bag", "csr_gather_sum_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p])
    wbag = parity_build.entry(
        path % "embedding_bag", "csr_gather_sum_weighted_launch",
        [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                 ctypes.c_void_p])
    bag16 = parity_build.entry(
        path % "embedding_bag", "csr_gather_sum16_launch",
        [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p])

    def gather_sum(src, idx, ptr, weight=None):
        rows = ptr.numel() - 1
        out = torch.empty(rows, src.shape[1], device=src.device,
                          dtype=src.dtype)
        stream = torch.cuda.current_stream().cuda_stream
        if src.dtype != torch.float32:
            status = bag16(src.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
                           out.data_ptr(), rows, src.shape[1],
                           platform.DTYPES[src.dtype], stream)
        elif weight is None:
            status = bag(src.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
                         out.data_ptr(), rows, src.shape[1], stream)
        else:
            status = wbag(src.data_ptr(), idx.data_ptr(), weight.data_ptr(),
                          ptr.data_ptr(), out.data_ptr(), rows, src.shape[1],
                          stream)
        if status:
            raise RuntimeError(f"{path % 'embedding_bag'}: launch {status}")
        return out

    return gather_sum, bind_lookup(path % "codebook_lookup")


def bind_lookup(path: str):
    """codebook_lookup(z, ix, binary) of the library at ``path``: f32
    tables through ``codebook_lookup_launch``, bf16 and f16 through
    ``codebook_lookup16_launch``; allocates its output like the
    wrapper."""
    import torch

    from repro_torch.kernels import platform

    head = [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 3
    wide = parity_build.entry(path, "codebook_lookup_launch",
                              head + [ctypes.c_void_p])
    narrow = parity_build.entry(path, "codebook_lookup16_launch",
                                head + [ctypes.c_int, ctypes.c_void_p])

    def lookup(z, ix, binary=False):
        out = torch.empty(ix.shape[0], z.shape[1], device=z.device,
                          dtype=z.dtype)
        args = (z.data_ptr(), ix.data_ptr(), out.data_ptr(), ix.shape[0],
                ix.shape[1], z.shape[1], int(binary))
        stream = torch.cuda.current_stream().cuda_stream
        status = (wide(*args, stream) if z.dtype == torch.float32
                  else narrow(*args, platform.DTYPES[z.dtype], stream))
        if status:
            raise RuntimeError(f"{path}: launch {status}")
        return out

    return lookup


def time_clean_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """``chip_smoke.time_ms`` with the L2 flushed by reading 64 MB rather
    than writing it: the timed call then evicts clean lines and pays no
    write-back of the flush's dirty ones."""
    import torch
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
    spin = chip_smoke.spin_cycles()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.max()
        torch.cuda._sleep(spin)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


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
    return bags, lookups, train


def more_inputs(train):
    """(src, idx, ptr, weight) of the other gather-sums on the port's
    paths: the weighted propagation of both sides over the amazonbook
    train split (weights 1/sqrt(deg_u deg_v), edges stably sorted by the
    summing side), the ordered W(k) sum, SASRec's item-table backward and
    Wide&Deep's wide table (ids uniform, seeded)."""
    import numpy as np
    import torch
    g = torch.Generator(device="cpu").manual_seed(31)
    dev = torch.device("cuda")
    eu = np.asarray(train.edge_u, np.int64)
    ev = np.asarray(train.edge_v, np.int64)
    du = np.bincount(eu, minlength=train.n_users).astype(np.float32)
    dv = np.bincount(ev, minlength=train.n_items).astype(np.float32)
    norm = (1.0 / np.sqrt(du[eu] * dv[ev])).astype(np.float32)
    out = {}
    for side, dest, src_ids, n_dest, n_src in (
            ("user", eu, ev, train.n_users, train.n_items),
            ("item", ev, eu, train.n_items, train.n_users)):
        order = np.argsort(dest, kind="stable")
        out[f"propagation {side} side (weighted)"] = (
            torch.randn(n_src, 64, generator=g).to(dev),
            torch.as_tensor(src_ids[order], dtype=torch.int32, device=dev),
            chip_smoke.csr_ptr(torch.as_tensor(dest[order], device=dev),
                               n_dest),
            torch.as_tensor(norm[order], device=dev))
    for what, nnz, rows, n_src, d in (
            ("ordered W(k) sum", 800_000, 1_000_000, 800_000, 1),
            ("SASRec items backward", 3_211_264, 250_112, 3_211_264, 50),
            ("Wide&Deep wide backward", 65_536, 250_112, 65_536, 1),
            ("SchNet ogb_products-sized segment sum", 7_732_480, 2_449_152,
             2_449_152, 64),
            ("SchNet minibatch_lg-sized segment sum", 168_960, 169_984,
             169_984, 64)):
        dest = torch.randint(0, rows, (nnz,), generator=g)
        dest_sorted, perm = torch.sort(dest, stable=True)
        src_ids = perm if n_src == nnz else torch.randint(
            0, n_src, (nnz,), generator=g)
        out[what] = (torch.randn(n_src, d, generator=g).to(dev),
                     src_ids.int().to(dev),
                     chip_smoke.csr_ptr(dest_sorted.to(dev), rows), None)
    return out


# (what, tokens, rows a token, d): the MoE token combine of
# ``transformer._Combine`` at the MoE LMs' shapes
MOE_SHAPES = (("dbrx-132b decode", 8, 4, 6144),
              ("kimi-k2 decode", 64, 8, 7168),
              ("dbrx-132b train_4k", 4096, 4, 6144),
              ("dbrx-132b prefill", 32768, 4, 6144),
              ("kimi-k2 prefill", 32768, 8, 7168))


def moe_inputs():
    """(what, rows bf16 [t k, d], perm, ptr, tok) of the MoE combines: t
    tokens of k expert rows each in a random expert-sorted order, as in
    ``tests/test_torch_cuda.py::test_csr_gather_sum_16bit_at_the_moe_shapes``;
    ``tok`` is each row's token (``index_add_``'s index)."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for what, t, k, d in MOE_SHAPES:
        tok = torch.randperm(t * k, generator=g, device=dev) // k
        perm = torch.sort(tok, stable=True).indices.int()
        ptr = torch.arange(0, t * k + 1, k, device=dev)
        rows = torch.randn(t * k, d, generator=g, device=dev).to(
            torch.bfloat16)
        out.append((what, rows, perm, ptr, tok))
    return out


WIDE_DS = (1000, 1024, 3584, 4100, 6144, 7168)


def wide_inputs():
    """(what, src, idx, ptr) of few wide rows, bf16 and f32: 1, 8 and 64
    rows of 0-40 values each (from 8 rows on one of 40, a long row),
    over a [500, d] source; d 1,000 and 4,100 are not a multiple of 32
    lane words."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(41)
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for d in WIDE_DS:
            src = torch.randn(500, d, generator=g).to(dev, dtype)
            for rows in (1, 8, 64):
                lens = torch.randint(0, 41, (rows,), generator=g)
                if rows >= 8:
                    lens[rows // 2] = 40
                ptr = torch.cat([torch.zeros(1, dtype=torch.int64),
                                 torch.cumsum(lens, 0)]).to(dev)
                idx = torch.randint(0, 500, (int(lens.sum()),), generator=g,
                                    dtype=torch.int32).to(dev)
                out.append((f"{name} d={d} rows={rows}", src, idx, ptr))
    return out


def inputs16():
    """(name, src, idx, ptr) of the 16-bit cases: the ``cuda`` tests'
    skewed bags in bf16 and f16 (an empty segment and a row of 1,000
    repeats among them), and the LM token embedding's gradient: the
    bf16 cotangent of one gemma2-9b microbatch (4,096 tokens, d 3,584)
    summed into 256,000 rows, token ids drawn from a Zipf law (rank r
    with weight 1 / r) as a frequent token repeats."""
    import torch
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(37)
    out = []
    for dtype in (torch.bfloat16, torch.float16):
        name = str(dtype).split(".")[-1]
        for d in (1, 3, 64, 129, 3584):
            idx, ptr = chip_smoke.skewed_csr(5000, 1000, g, dev)
            src = torch.randn(1000, d, generator=g).to(dev, dtype)
            out.append((f"{name} skewed d={d}", src, idx, ptr))
        rep = torch.zeros(1000, dtype=torch.int32, device=dev)
        ptr = torch.tensor([0, 0, 1000, 1000], dtype=torch.int64,
                           device=dev)
        out.append((f"{name} 1,000 repeats + empty rows",
                    torch.randn(1, 3584, generator=g).to(dev, dtype), rep,
                    ptr))
    out.append(("bfloat16 LM token gradient",) + lm_token_gradient(g))
    return out


def lm_token_gradient(g, tokens: int = 4096, vocab: int = 256_000,
                      d: int = 3584):
    """(g bf16 [tokens, d], idx int32 [tokens], ptr int64 [vocab + 1]):
    the token lookup's backward of one microbatch as ``scatter_rows``
    hands it to the kernel, ids Zipf-skewed."""
    import torch
    w = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64)
    ids = torch.multinomial(w, tokens, replacement=True, generator=g)
    cot = torch.randn(tokens, d, generator=g).to(torch.bfloat16).cuda()
    ids_sorted, perm = torch.sort(ids, stable=True)
    return (cot, perm.int().cuda(),
            chip_smoke.csr_ptr(ids_sorted.cuda(), vocab))


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
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for d in LOOKUP_DS:
            flat = torch.randn(501 * d + 1, generator=g).to(dev, dtype)
            for h in LOOKUP_HS:
                ix = torch.randint(0, 501, (1001, h), generator=g,
                                   dtype=torch.int32)
                if h > 1:
                    ix[::2, -1] = ix[::2, 0]
                ix = ix.to(dev)
                for off in (0, 1):
                    z = flat[off:off + 501 * d].view(501, d)
                    for binary in (False, True):
                        lookups.append((f"{name} d={d} H={h} off={off} "
                                        f"binary={binary}", z, ix, binary))
        lookups.append((f"{name} B=0", flat[:501 * d].view(501, d), ix[:0],
                        True))
    return bags, lookups


def lm_lookups():
    """(what, z bf16 [K, d], ix int32 [B, 1]) at ``LM_SHAPES``, one at a
    time (a table is up to 2.3 GB): a -0.0 row and a NaN row among the
    looked-up rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    for what, b, k, d in LM_SHAPES:
        z = torch.randn(k, d, generator=g, device="cuda").to(torch.bfloat16)
        ix = torch.randint(0, k, (b, 1), generator=g, device="cuda",
                           dtype=torch.int32)
        z[ix[0, 0]] = -0.0
        z[ix[-1, 0]] = float("nan")
        yield what, z, ix


def main(other_dir: str) -> int:
    import torch

    from repro_torch.kernels import codebook_lookup, csr_gather_sum, ref
    from repro_torch.kernels import cost as kcost

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

    bags, lookups, train = path_inputs()
    more = more_inputs(train)
    synthetic = synthetic_inputs()
    edge_bags, edge_lookups = edge_inputs()
    counts = {n: {"cases": 0, "bitwise": 0}
              for n in NAMES + ("embedding_bag 16-bit",
                                "codebook_lookup 16-bit")}
    unequal = []

    def words(x):                      # NaN compares by its bits
        return x.view(torch.int16) if x.element_size() == 2 else x

    def tally(name, what, *results):
        same = all(torch.equal(words(results[0]), words(r))
                   for r in results[1:])
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
    for what, (src, idx, ptr, w) in more.items():
        tally("embedding_bag", what, csr_gather_sum(src, idx, ptr, w),
              old_bag(src, idx, ptr, w), ref.csr_gather_sum(src, idx, ptr, w))
    cases16 = inputs16()
    for what, src, idx, ptr in cases16:
        tally("embedding_bag 16-bit", what, csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr), ref.csr_gather_sum(src, idx, ptr))
    moe = moe_inputs()
    for what, rows, perm, ptr, _ in moe:
        tally("embedding_bag 16-bit", f"MoE combine {what}",
              csr_gather_sum(rows, perm, ptr), old_bag(rows, perm, ptr),
              ref.csr_gather_sum(rows, perm, ptr))
    for what, src, idx, ptr in wide_inputs():
        name = ("embedding_bag" if src.dtype == torch.float32
                else "embedding_bag 16-bit")
        tally(name, f"wide {what}", csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr), ref.csr_gather_sum(src, idx, ptr))
    for what, (src, idx, ptr) in synthetic.items():
        tally("embedding_bag", what, csr_gather_sum(src, idx, ptr),
              old_bag(src, idx, ptr))
    for side, (z, ix) in lookups.items():
        tally("codebook_lookup", side, codebook_lookup(z, ix, binary=True),
              old_lookup(z, ix, True), ref.codebook_lookup(z, ix, True))
    for what, z, ix, binary in edge_lookups:
        name = ("codebook_lookup" if z.dtype == torch.float32
                else "codebook_lookup 16-bit")
        tally(name, what, codebook_lookup(z, ix, binary=binary),
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
    for what, (src, idx, ptr, w) in more.items():
        row = {"plain_ms": t(lambda: ref.csr_gather_sum(src, idx, ptr, w),
                             iters=5)}
        row["old_ms"] = [t(lambda: old_bag(src, idx, ptr, w))]
        row["new_ms"] = [t(lambda: csr_gather_sum(src, idx, ptr, w))
                         for _ in range(2)]
        row["old_ms"].append(t(lambda: old_bag(src, idx, ptr, w)))
        times[f"embedding_bag {what}"] = row
    what, src, idx, ptr = cases16[-1]
    ids = torch.empty(idx.numel(), dtype=torch.int64, device=idx.device)
    ids[idx.long()] = torch.repeat_interleave(      # each row's token id
        torch.arange(ptr.numel() - 1, device=ptr.device), ptr[1:] - ptr[:-1])
    times[f"embedding_bag 16-bit {what}"] = {
        "old_ms": [t(lambda: old_bag(src, idx, ptr))],
        "new_ms": [t(lambda: csr_gather_sum(src, idx, ptr))
                   for _ in range(2)],
        "plain_ms": t(lambda: ref.csr_gather_sum(src, idx, ptr), iters=5),
        "library_ms": t(lambda: torch.zeros(
            ptr.numel() - 1, src.shape[1], device=src.device).index_add_(
                0, ids, src.float()).to(src.dtype))}
    times[f"embedding_bag 16-bit {what}"]["old_ms"].append(
        t(lambda: old_bag(src, idx, ptr)))
    for what, rows, perm, ptr, tok in moe:
        row = {"old_ms": [t(lambda: old_bag(rows, perm, ptr))]}
        row["new_ms"] = [t(lambda: csr_gather_sum(rows, perm, ptr))
                         for _ in range(2)]
        row["old_ms"].append(t(lambda: old_bag(rows, perm, ptr)))
        row["library_ms"] = t(lambda: torch.zeros(
            ptr.numel() - 1, rows.shape[1], device=rows.device).index_add_(
                0, tok, rows.float()).to(rows.dtype))
        row["bound_ms"] = kcost.bound(kcost.csr_gather_sum(
            rows, perm, ptr, rows=rows.shape[0]))[0]
        times[f"embedding_bag 16-bit MoE combine {what}"] = row
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
    for what, z, ix in lm_lookups():
        tally("codebook_lookup 16-bit", what, codebook_lookup(z, ix),
              old_lookup(z, ix), ref.codebook_lookup(z, ix))
        ixl = ix[:, 0].long()
        row = {"old_ms": [t(lambda: old_lookup(z, ix))]}
        row["new_ms"] = [t(lambda: codebook_lookup(z, ix)) for _ in range(2)]
        row["old_ms"].append(t(lambda: old_lookup(z, ix)))
        row["library_ms"] = t(lambda: z[ixl])
        row["clean_l2_ms"] = time_clean_ms(lambda: codebook_lookup(z, ix))
        row["clean_l2_library_ms"] = time_clean_ms(lambda: z[ixl])
        row["bound_ms"] = kcost.bound(kcost.codebook_lookup(
            z, ix, rows=int(torch.unique(ix).numel())))[0]
        times[f"codebook_lookup 16-bit {what}"] = row
        del z
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Drives the serving main path at the full width of the ``lightgcn-baco``
   config: ``paperlike_dataset("amazonbook")`` -> ``ClusterEngine().build(
   d=64, ratio=0.25)`` on the GPU -> seeded codebooks -> artifact save/load
   -> ``RecsysSession`` (fused and dense, fp32 and int8) behind
   ``BatchDispatcher((1, 8, 64, 512))`` -> 52 requests. The kernels' launch
   counts are zeroed just before and read just after; each kernel must have
   run. Fused and dense top-k must agree (ids equal up to near-ties), and two
   GPU solves must give identical labels.
3. Drives the embedding layer's entry points (``repro_torch.embedding``) at
   the same width, on the main path's sketch (K_u 8,878 with H=2, K_v 17,136
   with H=1) and d=64 codebooks from ``init_params(seed=0)``: the codebook
   readout ``fused_topk(sketch=...)`` over items and users (B 1..512, f32
   and int8, mask, exclusions from the training edges), every user's bag of
   training items (sum and mean, forward and backward; also in a random
   order, with no sortedness declared), and the gradient of
   the base embeddings through the "cuda" backend, twice, against the
   "gather" backend. Its kernels' launch counts are zeroed just before and
   read just after; each must have run.
4. Holds each kernel against its plain PyTorch version on the card, at the
   paths' shapes and on edge cases (exact on integer-valued inputs, NaN
   scores), and times kernel, plain version and one PyTorch library call.
5. Profiles a few requests (device time per kernel, idle share), and checks
   the port end to end on a small input against itself on the CPU.

Prints a ``kernels`` JSON line, the ``nvidia-smi`` name/power line, and as
its last line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, if there is no CUDA device, if ``repro_torch`` is missing, or if any
phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the f32
# rate outside the tensor cores, used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the JAX package's values on this dataset and seed (CPU run)
JAX_REFERENCE = {"k_users": 8878, "k_items": 17136, "gamma": 0.0078125,
                 "iters": 1}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing helpers (CUDA events, L2 flushed before every launch)
# ---------------------------------------------------------------------------
def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    started with a cold L2 (a 64 MB buffer is rewritten before it)."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        times.append((a, b))
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in times)
    return ms[len(ms) // 2]


def bound(bytes_moved: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_scorer(u, items, scale=None, mask=None):
    """score(rows, ids) -> (u[rows]·items[ids] + mask[ids], Σ|u·item|),
    both f64 numpy, computed on the card; int8 ``items`` dequantize
    through ``scale``. The second value is what the f32 rounding of the
    dot product scales with."""
    import torch

    def score(rows, ids):
        r = torch.as_tensor(rows, dtype=torch.long, device=u.device)
        c = torch.as_tensor(ids, dtype=torch.long, device=u.device)
        v = items[c].double()
        if scale is not None:
            v = v * scale[c].double()[:, None]
        p = u[r].double() * v
        s = p.sum(-1)
        if mask is not None:
            s = s + mask[c].double()
        return s.cpu().numpy(), p.abs().sum(-1).cpu().numpy()
    return score


def topk_agree(vals_a, ids_a, vals_b, ids_b, score, rtol=1e-5, atol=1e-6):
    """Top-k lists agree: each row's ids are distinct, values allclose,
    and wherever the ids differ the two values at that rank are a
    near-tie AND each list's id there really scores the value it was
    returned with (``score`` from ``pair_scorer``). Returns #differing
    ids."""
    import numpy as np
    va, vb = np.asarray(vals_a), np.asarray(vals_b)
    ia, ib = np.asarray(ids_a), np.asarray(ids_b)
    require(va.shape == vb.shape and ia.shape == ib.shape,
            f"top-k shapes differ: {va.shape} vs {vb.shape}")
    for ids in (ia, ib):
        srt = np.sort(ids, axis=1)
        require(not (srt[:, 1:] == srt[:, :-1]).any(),
                "an id repeats within a top-k row")
    require(np.allclose(va, vb, rtol=rtol, atol=atol),
            f"top-k values differ: max |diff| "
            f"{float(np.max(np.abs(va - vb)))}")
    diff = ia != ib
    if diff.any():
        tie = (va[diff] == vb[diff]) | (
            np.abs(va[diff] - vb[diff]) <= atol + rtol * np.abs(vb[diff]))
        require(tie.all(), "top-k ids differ beyond near-ties")
        rows = np.nonzero(diff)[0]
        for vals, ids in ((va, ia), (vb, ib)):
            want, size = score(rows, ids[diff])
            got = vals[diff]
            ok = (got == want) | (np.abs(got - want) <= atol + rtol * size)
            require(ok.all(), "a top-k id does not score the value returned "
                    "with it")
    return int(diff.sum())


# ---------------------------------------------------------------------------
# phase 2: the main path
# ---------------------------------------------------------------------------
def sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def counted_kernels() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches, by
    the name the ``kernels`` line gives the kernel."""
    from repro_torch.kernels import (codebook_lookup, csr_gather_sum,
                                     fused_topk, fused_topk_codebook)
    return {"codebook_lookup": codebook_lookup, "fused_topk": fused_topk,
            "fused_topk_codebook": fused_topk_codebook,
            "embedding_bag": csr_gather_sum}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counted_kernels().items()}


def zero_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0


def main_path(workdir: str, dataset: str = "amazonbook",
              device: str = "cuda") -> dict:
    """The serving main path (``device="cpu"`` and a small dataset make a
    rehearsal of the same code on a machine without a GPU)."""
    import numpy as np
    import torch

    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import paperlike_dataset
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.models.lightgcn import (edge_norms, from_sketch,
                                             init_params)
    from repro_torch.serve import (BatchDispatcher, CompressedArtifact,
                                   RecsysSession)

    t0 = time.perf_counter()
    _, _, _, train, _ = paperlike_dataset(dataset, seed=0)
    t_data = time.perf_counter() - t0
    log(f"dataset {dataset}: {train.n_users} users, {train.n_items} items, "
        f"{train.n_edges} train edges ({t_data:.1f} s on the host)")

    zero_counts()

    engine = ClusterEngine(device=device)
    t0 = time.perf_counter()
    sketch = engine.build(train, d=64, ratio=0.25)
    sync(device)
    t_cluster = time.perf_counter() - t0
    build_stats = dict(engine.stats)        # the build's alone
    meta = sketch.meta
    got = {"k_users": sketch.k_users, "k_items": sketch.k_items,
           "gamma": meta["gamma"], "iters": meta["iters"]}
    log(f"cluster build: {t_cluster:.2f} s, sweeps={build_stats['sweeps']} "
        f"host_syncs={build_stats['host_syncs']}")
    log(f"cluster result  K_u={got['k_users']} K_v={got['k_items']} "
        f"gamma={got['gamma']} iters={got['iters']}")
    log(f"JAX reference   K_u={JAX_REFERENCE['k_users']} "
        f"K_v={JAX_REFERENCE['k_items']} gamma={JAX_REFERENCE['gamma']} "
        f"iters={JAX_REFERENCE['iters']} -> "
        f"{'match' if got == JAX_REFERENCE else 'MISMATCH'}")

    # two GPU solves of the selected gamma give identical labels
    wu, wv = make_weights(train, "hws")
    lab_a, it_a = engine.solve(train, wu, wv, meta["gamma"],
                               meta["eff_budget"])
    lab_b, it_b = engine.solve(train, wu, wv, meta["gamma"],
                               meta["eff_budget"])
    require(np.array_equal(lab_a, lab_b) and it_a == it_b,
            "two GPU solves gave different labels")
    log(f"determinism: two GPU solves at gamma={meta['gamma']} give "
        f"identical labels ({it_a} sweeps each)")

    t0 = time.perf_counter()
    mcfg = from_sketch(train, sketch, dim=64, n_layers=3)
    art = CompressedArtifact.from_parts(
        init_params(0, mcfg), {"edge_u": train.edge_u,
                               "edge_v": train.edge_v,
                               "edge_norm": edge_norms(train)},
        sketch, mcfg, {"params": "init_params(seed=0)"})
    path = art.save(os.path.join(workdir, "artifact"))
    loaded = CompressedArtifact.load(path)
    require(loaded.content_id() == art.content_id(),
            "artifact content_id changed across save/load")
    t_artifact = time.perf_counter() - t0
    log(f"artifact {art.content_id()} saved and loaded ({t_artifact:.1f} s)")

    rng = np.random.default_rng(0)
    sizes = [1, 8, 64, 512] + [int(s) for s in rng.integers(1, 513, 9)]
    batches = [rng.integers(0, train.n_users, s) for s in sizes]
    outputs, serve = {}, {}
    t0 = time.perf_counter()
    for quant in (False, True):
        src = loaded.quantize() if quant else loaded
        for scorer in ("fused", "dense"):
            session = RecsysSession.from_artifact(src, k=20, scorer=scorer,
                                                  device=device)
            disp = BatchDispatcher(session, (1, 8, 64, 512))
            disp.warmup()
            outs = [disp(b) for b in batches]
            for vals, ids in outs:
                require(np.isfinite(vals).all(), "non-finite top-k values")
                require(ids.min() >= 0 and ids.max() < train.n_items,
                        "top-k ids out of range")
            name = f"{scorer}-{'int8' if quant else 'fp32'}"
            outputs[name] = outs
            st = disp.stats()
            serve[name] = {"requests": st["requests"],
                           "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"]}
    sync(device)
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    launches = {name: counts[name]
                for name in ("codebook_lookup", "fused_topk")}
    n_requests = sum(v["requests"] for v in serve.values())
    log(f"served {n_requests} requests in {t_serve:.1f} s: {serve}")
    log(f"kernel launches on the main path: {launches}")
    require(launches["codebook_lookup"] > 0, "codebook_lookup never ran")
    require(launches["fused_topk"] > 0, "fused_topk never ran")
    for prec, src in (("fp32", loaded), ("int8", loaded.quantize())):
        params = {kk: torch.as_tensor(vv, device=device)
                  for kk, vv in src.serving_params().items()}
        statics = src.statics(torch.device(device))
        u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                        src.mcfg())
        n_diff = 0
        for b, (vf, idf), (vd, idd) in zip(batches, outputs[f"fused-{prec}"],
                                           outputs[f"dense-{prec}"]):
            require(vf.shape == (idf.shape[0], 20), "bad top-k shape")
            score = pair_scorer(u_all[torch.as_tensor(b, device=device)],
                                v_all, mask=statics.get("item_mask"))
            n_diff += topk_agree(vf, idf, vd, idd, score)
        log(f"fused vs dense top-k ({prec}): agree, {n_diff} ids differ "
            f"at near-ties")

    return {"train": train, "sketch": sketch, "loaded": loaded,
            "launches": launches, "serve": serve, "cluster_s": t_cluster,
            "cluster": got, "stats": build_stats}


# ---------------------------------------------------------------------------
# phase 3: the embedding layer's entry points
# ---------------------------------------------------------------------------
def embedding_inputs(run: dict, device: str) -> dict:
    """The main path's codebooks (init_params(seed=0)), sketch and
    training bags as tensors on ``device``, int8 codebooks beside them."""
    import torch

    from repro_torch.embedding import quantize_int8_rows

    train, sketch = run["train"], run["sketch"]
    params = run["loaded"].params

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=device)

    out = {}
    for side, table, idx in (("items", "item_table", sketch.item_idx),
                             ("users", "user_table", sketch.user_idx)):
        q, scale = quantize_int8_rows(params[table])
        out[side] = {"z": t(params[table]), "sketch": t(idx, torch.int32),
                     "q": t(q), "scale": t(scale)}
    out["values"] = t(train.edge_v, torch.int32)        # user-sorted edges
    out["segments"] = t(train.edge_u, torch.int64)
    out["n_users"], out["n_items"] = train.n_users, train.n_items
    return out


def readout_cases(emb: dict, side: str, b: int, device: str):
    """(u, kwargs) cases of the codebook readout of ``side`` for the
    first ``b`` users: f32 and int8, bare, with a mask (-inf on every
    97th item) and with exclusions (each user's training items; on the
    users side, the user itself)."""
    import torch

    from repro_torch.embedding import EmbeddingEngine, EmbeddingSpec

    us = emb["users"]
    n_users = emb["n_users"]
    u0 = EmbeddingEngine(EmbeddingSpec(n_users, 64, k_rows=us["z"].shape[0],
                                       n_hot=2)).codebook_lookup(
        us["z"], us["sketch"], torch.arange(b, device=device))
    tab = emb[side]
    n = int(tab["sketch"].shape[0])
    mask = torch.zeros(n, device=device)
    mask[::97] = float("-inf")
    if side == "items":
        sel = emb["segments"] < b
        excl = (emb["segments"][sel], emb["values"][sel])
    else:
        excl = (torch.arange(b, device=device),
                torch.arange(b, device=device))
    for quant in (False, True):
        base = ({"items": tab["q"], "scale": tab["scale"]} if quant
                else {"items": tab["z"]})
        for extra in ({}, {"mask": mask}, {"exclude": excl}):
            yield u0, {**base, "sketch": tab["sketch"], **extra}


def embedding_path(run: dict, device: str = "cuda") -> dict:
    """Drives ``repro_torch.embedding`` at full width (``device="cpu"``
    on a small dataset rehearses the same code without a GPU)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                       embedding_bag, fused_topk)
    from repro_torch.kernels import ref
    from repro_torch.models import lightgcn as L

    emb = embedding_inputs(run, device)
    k = 20
    t0 = time.perf_counter()
    zero_counts()
    # the codebook readout, against the plain version
    n_cases, n_diff = 0, 0
    for side in ("items", "users"):
        for b in (1, 8, 64, 512):
            for u, kw in readout_cases(emb, side, b, device):
                items = kw.pop("items")
                got_v, got_i = fused_topk(u, items, k, **kw)
                want_v, want_i = ref.fused_topk(u, items, k, **kw)
                sync(device)
                exp = ref.expand_items(items, kw.get("scale"), kw["sketch"])
                n_diff += topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(),
                                     want_i.cpu(),
                                     pair_scorer(u, exp, mask=kw.get("mask")))
                n_cases += 1
    log(f"codebook readout: {n_cases} cases (items N={emb['n_items']} H=1, "
        f"users N={emb['n_users']} H=2; B 1..512; f32/int8; mask; "
        f"exclusions) agree with the plain version ({n_diff} ids differ "
        f"at near-ties)")
    # exact on integer-valued codebooks, at the same shapes
    g = torch.Generator(device="cpu").manual_seed(2)
    for side in ("items", "users"):
        tab = emb[side]
        zi = torch.randint(-2, 3, tuple(tab["z"].shape), generator=g)
        zi = zi.float().to(device)
        ui = torch.randint(-2, 3, (512, 64), generator=g).float().to(device)
        got = fused_topk(ui, zi, k, sketch=tab["sketch"])
        want = ref.fused_topk(ui, zi, k, sketch=tab["sketch"])
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"codebook readout ({side}) not exact on integer inputs")
    log("codebook readout on integer-valued codebooks: exact (items, users)")

    # every user's bag of training items, over the expanded item table
    items = emb["items"]
    v0 = EmbeddingEngine(EmbeddingSpec(emb["n_items"], 64,
                                       k_rows=items["z"].shape[0])) \
        .codebook_lookup(items["z"], items["sketch"])
    vals, segs, n_users = emb["values"], emb["segments"], emb["n_users"]
    plain_sum = ref.embedding_bag(v0, vals, segs, n_users)
    cnt = torch.bincount(segs, minlength=n_users).clamp(min=1).float()
    for mode, want in (("sum", plain_sum),
                       ("mean", plain_sum / cnt[:, None])):
        got = embedding_bag(v0, vals, segs, n_users, mode=mode)
        require(torch.equal(got, want),
                f"bag lookup ({mode}) is not bitwise the plain version")
    # empty and single-value bags; the same bags with their values in a
    # random order (unsorted segment ids, no declaration)
    keep = (segs % 3 != 1) & (segs < 5000)
    first = torch.ones_like(keep)
    first[1:] = segs[1:] != segs[:-1]
    shuffled = torch.randperm(vals.numel(), generator=g).to(device)
    for name, sel in (("empty bags", keep), ("single values", first),
                      ("unsorted", shuffled)):
        got = embedding_bag(v0, vals[sel], segs[sel], n_users)
        want = ref.embedding_bag(v0, vals[sel], segs[sel], n_users)
        require(torch.equal(got, want), f"bag lookup ({name}) differs")
    log(f"bags: {vals.numel()} values in {n_users} bags over "
        f"[{emb['n_items']}, 64], sum and mean, empty and single-value "
        f"bags, unsorted bags: bitwise the plain version")
    # the bag backward
    w = torch.randn(n_users, 64, generator=g).to(device)

    def bag_grad(backend, mode):
        t = v0.detach().clone().requires_grad_(True)
        out = embedding_bag(t, vals, segs, n_users, mode=mode, via=backend)
        return torch.autograd.grad((out * w).sum(), t)[0]

    plain_grad = ref.embedding_bag(w, segs, vals, emb["n_items"])
    require(torch.equal(bag_grad("cuda", "sum"), plain_grad),
            "bag backward is not bitwise the plain backward")
    for mode in ("sum", "mean"):
        a, b_ = bag_grad("cuda", mode), bag_grad("cuda", mode)
        require(torch.equal(a, b_), f"bag backward ({mode}) not "
                f"deterministic")
        gat = bag_grad("gather", mode)
        require(torch.allclose(a, gat, rtol=1e-5, atol=1e-5),
                f"bag backward ({mode}) differs from the gather backend: "
                f"max |diff| {float((a - gat).abs().max())}")
    log("bag backward: bitwise the plain backward (sum), two runs bitwise "
        "equal, within 1e-5 of the gather backend (sum, mean)")

    # the base embeddings' gradient through each backend
    loaded = run["loaded"]
    statics = {"sketch_u": emb["users"]["sketch"],
               "sketch_v": emb["items"]["sketch"]}
    wu = torch.randn(emb["n_users"], 64, generator=g).to(device)
    wv = torch.randn(emb["n_items"], 64, generator=g).to(device)

    def base_grad(backend):
        cfg = dataclasses.replace(loaded.mcfg(), lookup_backend=backend)
        p = {kk: torch.as_tensor(vv, device=device).requires_grad_(True)
             for kk, vv in loaded.params.items()}
        u, v = L._base_embeddings(p, statics, cfg)
        loss = (u * wu).sum() + (v * wv).sum()
        return torch.autograd.grad(loss, [p["user_table"], p["item_table"]])

    a, b_, gat = base_grad("cuda"), base_grad("cuda"), base_grad("gather")
    for name, x, y, z in zip(("user_table", "item_table"), a, b_, gat):
        require(torch.equal(x, y), f"d/d{name} not deterministic")
        require(torch.allclose(x, z, rtol=1e-5, atol=1e-5),
                f"d/d{name} differs from the gather backend: max |diff| "
                f"{float((x - z).abs().max())}")
    log("base-embedding gradients (user and item codebooks): two cuda runs "
        "bitwise equal, within 1e-5 of the gather backend")
    sync(device)
    launches = launch_counts()
    log(f"embedding layer: {time.perf_counter() - t0:.1f} s; kernel "
        f"launches {launches}")
    for name in ("codebook_lookup", "fused_topk_codebook", "embedding_bag"):
        require(launches[name] > 0, f"{name} never ran on the embedding "
                f"layer's path")
    return {"emb": emb, "v0": v0, "launches": launches,
            "readout_cases": n_cases, "near_tie_ids": n_diff,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_codebook_lookup(run: dict) -> dict:
    import torch

    from repro_torch.kernels import codebook_lookup, ref

    dev = torch.device("cuda")
    params = run["loaded"].params
    sketch = run["sketch"]
    max_err = 0.0
    rows = {}
    for side, table, idx in (
            ("users", params["user_table"], sketch.user_idx),
            ("items", params["item_table"], sketch.item_idx)):
        z = torch.as_tensor(table, device=dev)
        ix = torch.as_tensor(idx, dtype=torch.int32, device=dev)
        got = codebook_lookup(z, ix, binary=True)
        want = ref.codebook_lookup(z, ix, binary=True)
        require(torch.equal(got, want),
                f"codebook_lookup ({side}) is not bitwise the plain version")
        max_err = max(max_err, float((got - want).abs().max()))
        b, h = ix.shape
        bytes_moved = 4 * (ix.numel() + z.numel() + b * z.shape[1])
        bms, by = bound(bytes_moved, b * h * z.shape[1])
        ixl = ix.long()
        rows[side] = {
            "shape": f"B={b} H={h} K={z.shape[0]} d={z.shape[1]}",
            "ms": time_ms(lambda: codebook_lookup(z, ix, binary=True)),
            "plain_ms": time_ms(lambda: ref.codebook_lookup(z, ix,
                                                            binary=True)),
            "library_ms": time_ms(lambda: z[ixl].sum(1)),
            "bound_ms": bms, "bound_by": by}
        log(f"codebook_lookup {side} {rows[side]['shape']}: bitwise equal; "
            f"{rows[side]}")
    # edge cases: duplicates within rows, H = 1..3, binary on and off,
    # integer-valued codebooks (so every sum is exact)
    g = torch.Generator(device="cpu").manual_seed(0)
    for h in (1, 2, 3):
        z = torch.randint(-8, 9, (97, 64), generator=g).float().to(dev)
        ix = torch.randint(0, 97, (1000, h), generator=g, dtype=torch.int32)
        if h > 1:
            ix[::3, 1] = ix[::3, 0]                 # forced duplicates
        ix = ix.to(dev)
        for binary in (False, True):
            got = codebook_lookup(z, ix, binary=binary)
            want = ref.codebook_lookup(z, ix, binary=binary)
            require(torch.equal(got, want),
                    f"codebook_lookup H={h} binary={binary} differs")
    log("codebook_lookup edge cases (H=1..3, duplicates, binary on/off): "
        "bitwise equal")
    main = rows["users"]
    return {"name": "codebook_lookup", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/codebook_lookup.cu",
            "replaces": "src/repro/kernels/codebook_lookup.py:98",
            "launches": run["launches"]["codebook_lookup"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "items": rows["items"]}


def check_fused_topk(run: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.embedding import dequantize_params
    from repro_torch.kernels import fused_topk, ref
    from repro_torch.models import lightgcn as L

    dev = torch.device("cuda")
    loaded = run["loaded"]
    params = {k: torch.as_tensor(v, device=dev)
              for k, v in loaded.params.items()}
    statics = loaded.statics(dev)
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    loaded.mcfg())
    n, d = v_all.shape
    k = 20
    max_err = 0.0
    per_b = {}

    def compare(u, v, exact=False, block=1024, **kw):
        nonlocal max_err
        got_v, got_i = fused_topk(u, v, k, block=block, **kw)
        want_v, want_i = ref.fused_topk(u, v, k, **kw)
        torch.cuda.synchronize()
        if exact:
            require(torch.equal(got_i, want_i) and torch.equal(got_v, want_v),
                    f"fused_topk not exact on integer inputs {kw.keys()}")
        else:
            topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(), want_i.cpu(),
                       pair_scorer(u, v, kw.get("scale"), kw.get("mask")))
        fin = torch.isfinite(want_v)
        require(torch.equal(fin, torch.isfinite(got_v)),
                "fused_topk -inf pattern differs")
        if fin.any():
            max_err = max(max_err,
                          float((got_v[fin] - want_v[fin]).abs().max()))

    for b in (1, 8, 64, 512):
        u = u_all[:b].contiguous()
        compare(u, v_all)
        bytes_moved = 4 * (u.numel() + v_all.numel() + 2 * b * k)
        bms, by = bound(bytes_moved, 2.0 * b * n * d)
        zeros = torch.zeros(n, device=dev)
        per_b[b] = {
            "ms": time_ms(lambda: fused_topk(u, v_all, k)),
            "plain_ms": time_ms(lambda: ref.fused_topk(u, v_all, k)),
            "library_ms": time_ms(
                lambda: torch.topk(u @ v_all.T + zeros, k)),
            "bound_ms": bms, "bound_by": by}
        log(f"fused_topk B={b} N={n} d={d} k={k}: agrees; {per_b[b]}")

    g = torch.Generator(device="cpu").manual_seed(1)
    # integer-valued scores: exact, with ties everywhere (tie order)
    ui = torch.randint(-2, 3, (64, 64), generator=g).float().to(dev)
    vi = torch.randint(-2, 3, (5000, 64), generator=g).float().to(dev)
    compare(ui, vi, exact=True)
    compare(ui, vi, exact=True, block=37)
    # fewer than k finite scores: fill with the lowest-id -inf items
    mask = torch.full((5000,), float("-inf"), device=dev)
    mask[torch.randperm(5000, generator=g)[:7].to(dev)] = 0.0
    compare(ui, vi, exact=True, mask=mask)
    # exclusions (including each row's true top items)
    _, top = ref.fused_topk(ui, vi, k)
    rows = torch.arange(64, device=dev).repeat_interleave(5)
    cols = top[:, :5].reshape(-1).long()
    extra_r = torch.randint(0, 64, (300,), generator=g).to(dev)
    extra_c = torch.randint(0, 5000, (300,), generator=g).to(dev)
    excl = (torch.cat([rows, extra_r]), torch.cat([cols, extra_c]))
    compare(ui, vi, exact=True, exclude=excl)
    compare(ui, vi, exact=True, exclude=excl, mask=mask)
    # int8 items with per-row scale: exact with power-of-two scales,
    # near-tie agreement with random ones
    q = torch.randint(-127, 128, (5000, 64), generator=g,
                      dtype=torch.int8).to(dev)
    pow2 = (2.0 ** torch.randint(-3, 2, (5000,), generator=g)).float().to(dev)
    compare(ui, q, exact=True, scale=pow2)
    sc = (torch.rand(5000, generator=g) * 0.02 + 1e-3).to(dev)
    compare(u_all[:64].contiguous(), q, scale=sc)
    # the main path's int8 tables, dequantized then propagated
    qp = {kk: torch.as_tensor(vv, device=dev)
          for kk, vv in loaded.quantize().serving_params().items()}
    uq, vq = L.all_embeddings(dequantize_params(qp), statics, loaded.mcfg())
    compare(uq[:512].contiguous(), vq)
    # k above the cap is refused
    try:
        fused_topk(ui, vi, 33)
        raise SmokeFailure("fused_topk accepted k above its cap")
    except ValueError:
        pass
    check_nan_order(ui, vi)
    log("fused_topk edge cases (ties, <k finite, exclusions, int8, k cap, "
        "NaN scores): pass")
    main = per_b[512]
    return {"name": "fused_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk.py:229",
            "launches": run["launches"]["fused_topk"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": f"B=512 N={n} d={d} k={k}",
            "by_batch": {str(b): per_b[b] for b in per_b}}


def check_nan_order(u, items, sketch=None) -> None:
    """NaN scores (a NaN query row, NaN item rows) rank first, lowest id
    first, in the kernel as in the plain version."""
    import torch

    from repro_torch.kernels import fused_topk, ref

    u = u.clone()
    items = items.clone()
    u[3] = float("nan")
    nan_rows = [7, 123, items.shape[0] - 1]
    items[nan_rows] = float("nan")
    if sketch is not None:                 # items that expand NaN rows
        sketch = sketch.clone()
        sketch[[5, 50, sketch.shape[0] - 1], 0] = torch.tensor(
            nan_rows, dtype=torch.int32, device=sketch.device)
    got = fused_topk(u, items, 20, sketch=sketch, block=61)
    want = ref.fused_topk(u, items, 20, sketch=sketch)
    require(torch.equal(got[1], want[1]) and torch.equal(
        torch.isnan(got[0]), torch.isnan(want[0])) and torch.equal(
        got[0].nan_to_num(), want[0].nan_to_num()),
        f"fused_topk ({'codebook' if sketch is not None else 'dense'}) "
        f"orders NaN scores unlike the plain version")
    require(bool(torch.isnan(got[0][:, 0]).all()), "NaN does not rank first")


def check_fused_topk_codebook(run: dict, emb_run: dict) -> dict:
    import torch

    from repro_torch.kernels import fused_topk_codebook, ref

    emb = emb_run["emb"]
    dev = emb["values"].device
    k = 20
    max_err = 0.0
    rows = {}
    g = torch.Generator(device="cpu").manual_seed(3)
    for side in ("items", "users"):
        tab = emb[side]
        sk = tab["sketch"]
        n, h = sk.shape
        kz, d = tab["z"].shape
        mask = torch.zeros(n, device=dev)
        per_b = {}
        for b in (1, 8, 64, 512):
            for quant in (False, True):
                z = tab["q"] if quant else tab["z"]
                scale = tab["scale"] if quant else None
                u = torch.randn(b, d, generator=g).to(dev)
                got = fused_topk_codebook(u, z, sk, k, scale=scale, mask=mask)
                want = ref.fused_topk(u, z, k, sketch=sk, scale=scale,
                                      mask=mask)
                exp = ref.expand_items(z, scale, sk)
                topk_agree(got[0].cpu(), got[1].cpu(), want[0].cpu(),
                           want[1].cpu(), pair_scorer(u, exp, mask=mask))
                max_err = max(max_err,
                              float((got[0] - want[0]).abs().max()))
                if quant:
                    continue
                z_bytes = z.numel() * z.element_size()
                bytes_moved = (4 * u.numel() + z_bytes + 4 * sk.numel()
                               + 4 * n + 8 * b * k)
                bms, by = bound(bytes_moved, 2.0 * b * n * d + n * h * d)
                per_b[b] = {
                    "ms": time_ms(lambda: fused_topk_codebook(
                        u, z, sk, k, mask=mask)),
                    "plain_ms": time_ms(lambda: ref.fused_topk(
                        u, z, k, sketch=sk, mask=mask), iters=10),
                    "library_ms": time_ms(lambda: torch.topk(
                        u @ ref.expand_items(z, None, sk).T + mask, k)),
                    "bound_ms": bms, "bound_by": by}
                log(f"fused_topk_codebook {side} B={b} N={n} K={kz} H={h} "
                    f"d={d} k={k}: agrees (f32, int8); {per_b[b]}")
        rows[side] = {"shape": f"B=512 N={n} K={kz} H={h} d={d} k={k}",
                      "by_batch": {str(b): per_b[b] for b in per_b}}
        int_u = torch.randint(-2, 3, (64, 64), generator=g).float().to(dev)
        check_nan_order(int_u, tab["z"][:5000].contiguous(), sk[:3000] % 5000)
    log("fused_topk_codebook NaN scores: same order as the plain version")
    main = rows["items"]["by_batch"]["512"]
    return {"name": "fused_topk_codebook", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fused_topk.cu",
            "replaces": "src/repro/kernels/fused_topk.py:347",
            "launches": emb_run["launches"]["fused_topk_codebook"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": rows["items"]["shape"], "by_side": rows}


def check_embedding_bag(run: dict, emb_run: dict) -> dict:
    import torch

    from repro_torch.kernels import csr_gather_sum, ref

    emb = emb_run["emb"]
    table = emb_run["v0"]
    vals, segs = emb["values"], emb["segments"]
    n_seg = emb["n_users"]
    ptr = torch.searchsorted(segs, torch.arange(n_seg + 1, device=segs.device))
    got = csr_gather_sum(table, vals, ptr)
    want = ref.csr_gather_sum(table, vals, ptr)
    require(torch.equal(got, want),
            "embedding_bag kernel is not bitwise its plain version")
    n, d = table.shape
    nnz = vals.numel()
    bytes_moved = 4 * table.numel() + 4 * nnz + 8 * (n_seg + 1) + 4 * n_seg * d
    bms, by = bound(bytes_moved, nnz * d)
    seg = segs.long()
    row = {"ms": time_ms(lambda: csr_gather_sum(table, vals, ptr)),
           "plain_ms": time_ms(lambda: ref.csr_gather_sum(table, vals, ptr),
                               iters=5),
           "library_ms": time_ms(lambda: torch.zeros(
               n_seg, d, device=table.device).index_add_(
               0, seg, table[vals])),
           "bound_ms": bms, "bound_by": by}
    log(f"embedding_bag nnz={nnz} S={n_seg} N={n} d={d}: bitwise; {row}")
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:56",
            "launches": emb_run["launches"]["embedding_bag"],
            "max_abs_err": float((got - want).abs().max()), **row,
            "shape": f"nnz={nnz} S={n_seg} N={n} d={d}"}


# ---------------------------------------------------------------------------
# where a request's device time goes (torch.profiler, fused scorer, B=64)
# ---------------------------------------------------------------------------
def profile_requests(run: dict, batch: int = 64, n: int = 5) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import RecsysSession

    session = RecsysSession.from_artifact(run["loaded"], k=20,
                                          scorer="fused", device="cuda")
    ids = np.arange(batch)
    session(ids)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()          # the requests, not profiler set-up
        for _ in range(n):
            session(ids)                  # each ends in a synchronize
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and not e.key.startswith(("aten::", "cuda")):
            per_kernel[e.key[:70]] = t / 1e3 / n           # ms per request
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    out = {"batch": batch, "requests": n,
           "device_ms_per_request": busy,
           "wall_ms_per_request": wall_ms / n,
           "idle_share": 1.0 - busy / (wall_ms / n),
           "top_kernels_ms": dict(top)}
    log(f"profile (fused, B={batch}, {n} requests): device busy "
        f"{busy:.3f} ms of {wall_ms / n:.3f} ms per request")
    for name, ms in top:
        log(f"  {ms:8.3f} ms  {100 * ms / busy:5.1f}%  {name}")
    return out


# ---------------------------------------------------------------------------
# phase 5: small input, GPU against the port's own CPU (plain) path
# ---------------------------------------------------------------------------
def small_reference() -> None:
    import numpy as np

    import torch

    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.models.lightgcn import (edge_norms, from_sketch,
                                             init_params)
    from repro_torch.serve import CompressedArtifact

    _, _, _, train, _ = paperlike_dataset("gowalla_s", seed=0)
    sk = {dev: ClusterEngine(device=dev).build(train, d=64, ratio=0.25)
          for dev in ("cuda", "cpu")}
    require(np.array_equal(sk["cuda"].user_idx, sk["cpu"].user_idx)
            and np.array_equal(sk["cuda"].item_idx, sk["cpu"].item_idx)
            and sk["cuda"].meta["gamma"] == sk["cpu"].meta["gamma"],
            "GPU and CPU sketches differ on gowalla_s")
    mcfg = from_sketch(train, sk["cuda"], dim=64)
    art = CompressedArtifact.from_parts(
        init_params(1, mcfg), {"edge_u": train.edge_u,
                               "edge_v": train.edge_v,
                               "edge_norm": edge_norms(train)},
        sk["cuda"], mcfg)
    ids = np.arange(0, train.n_users, 7)
    sess = {dev: art.session(k=20, scorer="fused", device=dev)
            for dev in ("cuda", "cpu")}
    out = {dev: sess[dev](ids) for dev in sess}
    gpu = sess["cuda"]
    u, v = L.eval_embeddings(dequantize_params(gpu.params), gpu.statics,
                             gpu.mcfg, torch.as_tensor(ids, device="cuda"))
    n_diff = topk_agree(out["cuda"][0].cpu(), out["cuda"][1].cpu(),
                        out["cpu"][0], out["cpu"][1],
                        pair_scorer(u, v, mask=gpu.statics.get("item_mask")))
    log(f"gowalla_s: GPU sketch == CPU sketch (K_u={sk['cuda'].k_users}, "
        f"K_v={sk['cuda'].k_items}); GPU fused top-k == CPU top-k for "
        f"{ids.size} users ({n_diff} ids differ at near-ties)")


def main() -> int:
    try:
        import torch
    except ImportError:
        log("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    try:
        import repro_torch  # noqa: F401
        from repro_torch.kernels import platform
    except ImportError as e:
        log(f"FAIL: the port is not importable from {ROOT}/src: {e}")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        smi = gpu_line()
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"{torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        report = platform.build()
        log(f"kernel build: {time.perf_counter() - t0:.1f} s "
            f"({ {k: round(v['seconds'], 1) for k, v in report.items()} })")
        for name, r in report.items():
            for line in r["log"].splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")
        with tempfile.TemporaryDirectory(dir=os.path.join(
                ROOT, "build")) as workdir:
            run = main_path(workdir)
            emb_run = embedding_path(run)
            kernels = [check_codebook_lookup(run), check_fused_topk(run),
                       check_fused_topk_codebook(run, emb_run),
                       check_embedding_bag(run, emb_run)]
            prof = profile_requests(run)
        small_reference()
    except (SmokeFailure, RuntimeError, ValueError, AssertionError) as e:
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": {
        "cluster_s": run["cluster_s"], "cluster": run["cluster"],
        "solver_stats": run["stats"], "serve": run["serve"],
        "profile": prof}}))
    print(json.dumps({"embedding_path": {
        "seconds": emb_run["seconds"], "launches": emb_run["launches"],
        "readout_cases": emb_run["readout_cases"],
        "near_tie_ids": emb_run["near_tie_ids"]}}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel) and prints the build seconds.
2. Drives the main path at the full width of the ``lightgcn-baco`` config:
   ``paperlike_dataset("amazonbook")`` -> ``ClusterEngine().build(d=64,
   ratio=0.25)`` on the GPU -> training: ``Trainer`` with the launcher's
   defaults (fused backend, 600 steps of batch 2,048, lr 5e-3, chunks of
   16), ms per step (median of the chunks after the first), first and
   last loss, Recall/NDCG@20 on the test split (4,096 users, "block" and
   "fused" top-k) of the untrained ``init_params(0)`` and the trained
   codebooks, one warm chunk under ``torch.cuda.set_sync_debug_mode(
   "error")`` -> ``Trainer.export`` -> artifact load -> ``RecsysSession``
   (fused and dense, fp32 and int8) over the trained codebooks behind
   ``BatchDispatcher((1, 8, 64, 512))`` -> 52 requests. Training and
   serving each zero the kernels' launch counts just before and read them
   just after; each kernel of the path must have run. Training must lower
   the loss and raise Recall@20. Off the timed path: 32 steps of ``host``
   with the device sampler bitwise equal to ``fused``, and a kill at step
   32 and resume from its checkpoint bitwise equal to 64 uninterrupted
   steps. Fused and dense top-k must agree (ids equal up to near-ties),
   and two GPU solves must give identical labels.
   Then the stream (``repro_torch.stream``) at amazonbook's width
   (``STREAM_ARGS``: 52,643 users, 91,599 items, k_true 300, 4 waves
   after a warm prefix of 31,586 x 54,959): BACO (d 64, ratio 0.25) and
   200 fused training steps on the warm prefix, then ``replay`` (refresh
   every 2 steps with 40 tune steps, 8 requests of 64 users a step) into
   a capacity-padded fused-fp32 session with the launcher's caps. Labels
   and sketch digests must equal ``STREAM_REFERENCE`` (the JAX package's
   replay) at every step; every swap must allocate no device state (no
   capacity bump, every state tensor's ``data_ptr`` kept); the padded
   session's top-k must equal a fresh unpadded session's over the final
   artifact; its int8 quantization is swapped into a padded fused and a
   padded dense session, which must agree. Launch counts are zeroed just
   before the replay and read just after; codebook_lookup, the weighted
   CSR gather-sum and fused_topk must have run. It prints a ``stream``
   JSON line.
   Then the serving front end (``repro_torch.frontdoor``) over the
   trained export, as ``python -m repro_torch.launch.load_bench`` sets
   it up: ``web`` alone on a capacity-padded fused fp32 session,
   ``mobile`` and ``beta`` on one fused int8 session over its
   quantization, buckets (1, 8, 64), ``flush_ms`` 2, a 256-deep queue
   that sheds, a 1,024-entry hot-user cache. v2 is the main path's
   trainer fine-tuned 40 more steps and shipped as a verified delta.
   Two open-loop runs of 4 s on fresh tenants, at 120 and at 600 qps
   offered (bursts 2x, Zipf 1.1 users, sizes 1-8, tenant weights 0.5 /
   0.3 / 0.2), ``web`` swapping to v2 halfway. Launch counts are zeroed
   just before each run and read just after; codebook_lookup, the
   weighted CSR gather-sum and fused_topk must have run. Every arrival
   must be accounted for (responses + shed + timeouts + failed ==
   offered, no failure, no shed at 120 qps); every device batch, at its
   own padded bucket, and every response must equal a fresh session of
   the version that served it (bitwise or within ``topk_agree``'s
   near-ties); each ``web`` response must be wholly v1 or wholly v2, v2
   if submitted after the swap returned and v1 if resolved before it
   began; the swap must be ``swapped`` and allocate no device state
   across the registry. The change in the caching allocator's segments
   over each run is printed, not gated. It prints a ``frontdoor`` JSON
   line.
   Then the cluster build at scale (``repro_torch.launch.cluster_scale``:
   ``planted_coclusters`` at average degree 8, gamma 0.5, 8 sweeps). The
   100k rung (80,000 x 20,000, 286,695 edges): the streamed solve at
   ``block_edges`` 1<<20 and 1<<12, the in-memory solve and
   ``torch_hostloop``; the 1M rung (800,000 x 200,000, 2,647,670 edges):
   streamed at 1<<20 and 1<<14 (an oversized block for the item of
   degree 21,974), then in memory. Every solve of a rung gives the same
   labels and sweeps, equal to ``SCALE_REFERENCE`` (the JAX package's
   CPU solve); the streamed solves run on a graph no in-memory solve has
   touched, and at the smaller block size their peak device bytes (from
   a reset peak) must lie below the in-memory solve's. The minhash
   cold-assign experiment runs at 100k. Launch counts are zeroed just
   before the first solve and read just after the last; the CSR
   gather-sum (the ordered W(k) sums) must have run; the W(k) sums of
   each rung's final labels are then held bitwise against their plain
   version and timed. It prints a ``scale`` JSON line.
   Then the paper's comparison on the main path's graph (budget 0.25 x
   nodes): the ``random``, ``frequency``, ``double``, ``hybrid``, ``lsh``,
   ``lp`` and ``lpab`` sketches (``lp``/``lpab`` on the GPU solver, equal
   to the CPU port's at gowalla_s), their K and parameters against full;
   ``double`` (2-hot on both sides) trained 200 fused steps (batch
   2,048), Recall/NDCG@20 on 4,096 test users beside BACO's, exported,
   ``n_params``/``serving_nbytes`` in fp32 and int8 (int8 smaller), 13
   fused requests bitwise a fresh session's; launch counts around the
   training and the serving (codebook_lookup with items H = 2, the CSR
   gather-sum, fused_topk must run); the items' H = 2 lookup held
   against its plain version and timed. It prints a ``baselines`` JSON
   line.
3. Drives the embedding layer's entry points (``repro_torch.embedding``) at
   the same width, on the main path's sketch (K_u 8,878 with H=2, K_v 17,136
   with H=1) and its trained d=64 codebooks: the codebook
   readout ``fused_topk(sketch=...)`` over items and users (B 1..512, f32
   and int8, mask, exclusions from the training edges), every user's bag of
   training items (sum and mean, forward and backward; also in a random
   order, with no sortedness declared), and the gradient of
   the base embeddings through the "cuda" backend, twice, against the
   "gather" backend. Its kernels' launch counts are zeroed just before and
   read just after; each must have run.
4. Drives the path of DLRM's dot interaction and flash attention, the
   port's kernel bench (``repro_torch.launch.kernel_bench``): ``run(fast=
   False)`` (the four classic ops at the bench's full shapes, with the
   attention's max error against ``ref.mha``) and its JSON sweep (every
   lookup backend, the fused scorer against the dense path), plus one
   bf16 qwen1.5-32b layer (H 40, S 4,096, d 128) through
   ``ops.flash_attention``. Launch counts are zeroed just before and read
   just after; both kernels, and both of flash_attention's routes (f32 on
   the CUDA cores, bf16 on the tensor cores), must have run.
5. Holds each kernel against its plain PyTorch version on the card, at the
   paths' shapes and on edge cases (exact on integer-valued inputs, NaN
   scores), and times kernel, plain version and one PyTorch library call.
   dot_interaction at dlrm-mlperf's width (F 27, d 128) and its training
   batch (B 65,536), f32 and bf16, and at B 2,048 and 512; flash_attention
   at one layer of qwen1.5-32b (H 40, d 128) at S 4,096, bf16, causal, and
   at the bench's full shape (B 2, H 8, S 2,048, d 128, f32, causal and
   not), and checks that each shape ran the route its dtype and d choose
   (tensor cores for bf16/f16 at d <= 128). Tolerances: f32 rtol 2e-4 /
   atol 2e-5; bf16 and f16 one rounding step of the type (rtol 1.5 x its
   eps, atol 1e-4); dot_interaction bitwise on integer inputs. Bounds
   charge products of two bf16 or f16 values at the bf16/f16 tensor rate
   and all other operations at the f32 rate; the 16-bit attention rows
   count every product at the tensor rate (their P·V runs on the tensor
   cores). fused_topk and its codebook variant also repeat bitwise over
   two calls. The CSR gather-sum (embedding_bag) is held bitwise and
   timed at the bag forward, the bag backward and both codebook
   gradients (``backward`` in its entry), and on skewed bags (4,000
   values beside 0-3-value and empty bags) at d 1..600; its weighted
   instantiation (the LightGCN propagation, ``weighted`` in its entry)
   bitwise at the propagation's two shapes, through ``_Propagate``
   forward and backward, and on edge cases (zero, -0.0 and negative
   weights, skewed bags, one row of 100,000 values), timed beside
   ``index_add_`` and the previous cumsum route; codebook_lookup
   at H 1..5 and 40, d 1..129, on unaligned codebooks. Every timing
   enqueues a ~0.1 ms device spin before its start event, so it times
   the device and not the host's enqueue; the timer's floor (a
   one-element add) is printed once.
6. Profiles a few requests (device time per kernel, idle share), and checks
   the port end to end on a small input against itself on the CPU,
   serving and 20 training steps (losses to rtol 1e-5).

Prints a ``stream`` JSON line, a ``frontdoor`` JSON line, a ``scale``
and a ``baselines`` JSON line, a ``kernels`` JSON line, a ``timer`` line
(the timer's floor), the ``nvidia-smi`` name/power line, and as its last
line ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, if there is no CUDA device, if ``repro_torch`` is missing, or if any
phase fails. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bandwidth, the
# f32 rate outside the tensor cores, and the bf16/f16 tensor-core rate with
# f32 accumulation, used for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F16_OPS_PER_S = 989e12
# the JAX package's values on this dataset and seed (CPU run)
JAX_REFERENCE = {"k_users": 8878, "k_items": 17136, "gamma": 0.0078125,
                 "iters": 1}

# the frontdoor phase: 4 s open-loop runs at the reference load bench's
# 120 qps (no request may be shed) and at 600 qps
FRONTDOOR_RATES = (120.0, 600.0)
FRONTDOOR_DURATION_S = 4.0

# the stream phase's stream (amazonbook's users, items and k_true)
STREAM_ARGS = dict(n_users=52_643, n_items=91_599, k_true=300, avg_deg=10,
                   T=4, drift=0.05, seed=0)
# the JAX package's update-only replay of that stream on the CPU,
# pinned with `PYTHONPATH=src python tests/test_torch_stream.py`
# (``reference_stream_pins``: BACO d 64 ratio 0.25 on the warm prefix,
# then replay(updater, stream.steps, None, ReplayConfig(refresh_every=2,
# tune_steps=0)) with the launcher's caps): per step, adopted cold users
# and items, refresh sweeps and gamma, K_u and K_v, and the sha256 (its
# first 32 hex digits) of the labels and the sketch's index arrays
STREAM_REFERENCE = {
    "stream": {"n_warm_users": 31586, "n_warm_items": 54959,
               "base_edges": 118843, "total_edges": 514160},
    "bootstrap": {
        "k_users": 11364, "k_items": 30445, "gamma": 16.0,
        "iters": 5,
        "labels": "8b1ea76e3f0438ca034698d9220c682e",
        "user_idx": "7d22326e586a3f98389bcc214f71615f",
        "item_idx": "461dd194eeabcf0fe733d79650d3898d"},
    "steps": [
        {"adopted_users": 5264, "adopted_items": 8335,
         "k_users": 12647, "k_items": 31276,
         "labels": "e7b6a24e5c13c4c3b68fb8f65c626d6d",
         "user_idx": "7f268a8413f68e715e57d95b10c0bf39",
         "item_idx": "81c0effd2e715318b84ef63411ad145c"},
        {"adopted_users": 5264, "adopted_items": 8187, "sweeps": 7,
         "gamma": 16.0,
         "k_users": 14441, "k_items": 32268,
         "labels": "c26dad8b20105f71e4085c38f3d2b75b",
         "user_idx": "6b085c66bdacadb2a1656b1e3deea6cb",
         "item_idx": "149e8840fabda50262559032571f677e"},
        {"adopted_users": 5264, "adopted_items": 8214,
         "k_users": 15647, "k_items": 33221,
         "labels": "50b6a089c4802e7826da0a9a2d73248e",
         "user_idx": "c7e6b6ad1ae77d4083bb3c81d951d94d",
         "item_idx": "9fc12f5d420794490e7dd6b9f61db426"},
        {"adopted_users": 5265, "adopted_items": 8269, "sweeps": 7,
         "gamma": 16.0,
         "k_users": 16987, "k_items": 34131,
         "labels": "373cee0574b7bd28f440d471e073c231",
         "user_idx": "010aa68781356831971bcfb6f85e74f1",
         "item_idx": "3f89b06a4ea2f1057fc212898d4bab2a"},
    ]}


# the scale phase: the reference's in-memory solve (gamma 0.5, 8 sweeps)
# of the cluster-scale ladder's rungs on the CPU, pinned with
# `PYTHONPATH=src python tests/test_torch_scale.py`: edges, the sha256 (its
# first 32 hex digits) of the int32 labels, sweeps and Barber modularity
SCALE_REFERENCE = {
    "100k": {"n_edges": 286695, "labels": "cbfa03236c3d9dcdd8901fe0b02904ef",
             "iters": 8, "modularity": 0.6553885850996158},
    "1m": {"n_edges": 2647670, "labels": "9a490abd9bd75e2482de03d1b582ef50",
           "iters": 8, "modularity": 0.6298310676219552},
}
# streamed block sizes per rung; 1<<14 at 1M forces an oversized block for
# the item of degree 21,974
SCALE_BLOCKS = {"100k": (1 << 20, 1 << 12), "1m": (1 << 20, 1 << 14)}
# the baselines phase: the hashing, LSH and LP sketches built at full
# amazonbook width, and the 2-hot one trained, exported and served
BASELINE_METHODS = ("random", "frequency", "double", "hybrid", "lsh", "lp",
                    "lpab")
BASELINE_TRAIN_STEPS = 200


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
_SPIN = {}


def spin_cycles(us: float = 100.0) -> int:
    """Cycles of ``torch.cuda._sleep`` that keep the card busy for about
    ``us`` microseconds (calibrated once per process with CUDA events)."""
    import torch
    if "per_us" not in _SPIN:
        cycles = 1_000_000
        torch.cuda._sleep(cycles)                 # warm-up
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        torch.cuda.synchronize()
        _SPIN["per_us"] = cycles / (a.elapsed_time(b) * 1e3)
    return int(us * _SPIN["per_us"])


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``iters`` launches, each
    started with a cold L2 (a 64 MB buffer is rewritten before it). A
    ~0.1 ms device spin sits between the flush and the start event, so
    the card is still busy while the host enqueues ``fn``'s work: the
    events time the device, not the host's enqueue."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    spin = spin_cycles()
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
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


def timer_floor_ms() -> float:
    """:func:`time_ms` around a one-element add: the least time it can
    report for one launch."""
    import torch
    x = torch.zeros(1, device="cuda")
    return time_ms(lambda: x.add_(1.0))


def bound(bytes_moved: float, ops: float, ops16: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over their type's rate: ``ops`` at the f32 rate, ``ops16``
    (products of two bf16 or f16 values, exact in f32, summed in f32) at
    the bf16/f16 tensor rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_OPS_PER_S + ops16 / F16_OPS_PER_S) * 1e3
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
                                     dot_interaction, flash_attention,
                                     fused_topk, fused_topk_codebook)
    return {"codebook_lookup": codebook_lookup, "fused_topk": fused_topk,
            "fused_topk_codebook": fused_topk_codebook,
            "embedding_bag": csr_gather_sum,
            "dot_interaction": dot_interaction,
            "flash_attention": flash_attention}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in counted_kernels().items()}


def zero_counts() -> None:
    for fn in counted_kernels().values():
        fn.launches = 0
    fa = counted_kernels()["flash_attention"]
    fa.launches_tc = fa.launches_cc = 0
    counted_kernels()["embedding_bag"].launches_weighted = 0


def flash_routes() -> dict:
    """flash_attention's launches by route: tensor cores, CUDA cores."""
    fa = counted_kernels()["flash_attention"]
    return {"tc": fa.launches_tc, "cc": fa.launches_cc}


def main_path(workdir: str, dataset: str = "amazonbook",
              device: str = "cuda", train_steps: int = 600) -> dict:
    """The main path: BACO, training (:func:`train_path`), export, and
    serving the exported codebooks (``device="cpu"`` and a small dataset
    make a rehearsal of the same code on a machine without a GPU)."""
    import numpy as np
    import torch

    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import paperlike_dataset
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.serve import (BatchDispatcher, CompressedArtifact,
                                   RecsysSession)

    t0 = time.perf_counter()
    _, _, _, train, test = paperlike_dataset(dataset, seed=0)
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
    cluster_launches = launch_counts()["embedding_bag"]
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

    trained = train_path(train, test, sketch, workdir, device,
                         steps=train_steps)
    art = trained["artifact"]
    t0 = time.perf_counter()
    loaded = CompressedArtifact.load(trained["path"])
    require(loaded.content_id() == art.content_id(),
            "artifact content_id changed across save/load")
    require(loaded.provenance.get("train_steps") == train_steps,
            "the served artifact is not the trained export")
    t_artifact = time.perf_counter() - t0
    log(f"serving the trained export {art.content_id()} "
        f"({t_artifact:.1f} s to load)")

    zero_counts()

    rng = np.random.default_rng(0)
    sizes = [1, 8, 64, 512] + [int(s) for s in rng.integers(1, 513, 9)]
    batches = [rng.integers(0, train.n_users, s) for s in sizes]
    outputs, serve, n_warmups = {}, {}, 0
    t0 = time.perf_counter()
    for quant in (False, True):
        src = loaded.quantize() if quant else loaded
        for scorer in ("fused", "dense"):
            session = RecsysSession.from_artifact(src, k=20, scorer=scorer,
                                                  device=device)
            disp = BatchDispatcher(session, (1, 8, 64, 512))
            disp.warmup()
            n_warmups += len(disp.buckets)
            outs, b512_ms = [], None
            for b in batches:
                t_req = time.perf_counter()
                outs.append(disp(b))
                if b.size == 512 and b512_ms is None:
                    b512_ms = (time.perf_counter() - t_req) * 1e3
            for vals, ids in outs:
                require(np.isfinite(vals).all(), "non-finite top-k values")
                require(ids.min() >= 0 and ids.max() < train.n_items,
                        "top-k ids out of range")
            name = f"{scorer}-{'int8' if quant else 'fp32'}"
            outputs[name] = outs
            st = disp.stats()
            serve[name] = {"requests": st["requests"],
                           "p50_ms": st["p50_ms"], "p99_ms": st["p99_ms"],
                           "b512_ms": b512_ms}
    sync(device)
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    launches = {name: counts[name]
                for name in ("codebook_lookup", "fused_topk", "embedding_bag")}
    n_requests = sum(v["requests"] for v in serve.values())
    # every session call, the dispatchers' warm-up calls included
    n_calls = n_requests + n_warmups
    weighted_per_request = weighted_launches() / n_calls
    log(f"served {n_requests} requests in {t_serve:.1f} s: {serve}")
    log(f"kernel launches on the serving path: {launches} (weighted CSR "
        f"gather-sum: {weighted_per_request:g} a request)")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the serving path")
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

    return {"train": train, "test": test, "sketch": sketch,
            "loaded": loaded, "launches": launches, "serve": serve,
            "cluster_s": t_cluster, "cluster_launches": cluster_launches,
            "cluster": got, "stats": build_stats, "training": trained,
            "weighted_per_request": weighted_per_request}


def weighted_launches() -> int:
    from repro_torch.kernels import csr_gather_sum
    return csr_gather_sum.launches_weighted


def sync_free_chunk(trainer, n: int, device: str):
    """One fused chunk of ``n`` steps with every synchronizing call made
    an error (``torch.cuda.set_sync_debug_mode("error")``): the chunk
    only enqueues work. Returns its losses (host list)."""
    import torch
    if device != "cuda":
        return trainer.backend.chunk(trainer, n).tolist()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = trainer.backend.chunk(trainer, n)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return losses.tolist()


def train_path(train, test, sketch, workdir: str, device: str = "cuda",
               steps: int = 600, chunk: int = 16) -> dict:
    """LightGCN + BPR on the main path's sketch with the launcher's
    defaults (``python -m repro_torch.launch.train``: fused backend, batch
    2,048, lr 5e-3, seed 0, chunks of 16), Recall/NDCG@20 on the test
    split before and after (top-k by "block" and "fused"), one warm chunk
    under sync-debug "error", and the export the sessions then serve.
    Then, off the timed path: ``host`` with the device sampler bitwise
    equal to ``fused`` over 32 steps, and a kill at step 32 and resume
    from its checkpoint bitwise equal to 64 uninterrupted steps."""
    import math
    import statistics

    import torch

    from repro_torch.training import TrainConfig, Trainer

    cfg = TrainConfig(steps=steps, batch_size=2048, lr=5e-3, seed=0,
                      backend="fused", chunk_size=chunk)
    tr = Trainer(train, sketch, cfg, device=device)

    def evaluate():
        t0 = time.perf_counter()
        out = {b: tr.evaluate(test, max_users=4096, topk_backend=b)
               for b in ("block", "fused")}
        sync(device)
        require(abs(out["block"]["recall"] - out["fused"]["recall"]) <= 5e-3
                and abs(out["block"]["ndcg"] - out["fused"]["ndcg"]) <= 5e-3,
                f"block and fused top-k disagree on Recall/NDCG: {out}")
        return out, time.perf_counter() - t0

    untrained, _ = evaluate()
    log(f"untrained init_params(0) codebooks: {untrained}")

    zero_counts()
    sync(device)
    losses, per_step_ms = [], []
    t_train = time.perf_counter()
    while tr.step < steps:
        t0 = time.perf_counter()
        losses += tr.run(steps=min(tr.step + chunk, steps), log_every=0)
        per_step_ms.append((time.perf_counter() - t0) * 1e3 / chunk)
        if tr.step == chunk and steps >= 2 * chunk:
            losses += sync_free_chunk(tr, chunk, device)
            log(f"a warm chunk of {chunk} steps ran under sync-debug "
                f"'error': no host sync")
    sync(device)
    t_train = time.perf_counter() - t_train
    weighted_per_step = weighted_launches() / steps
    require(len(losses) == steps and all(math.isfinite(x) for x in losses),
            "training losses are not finite")
    require(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
            f"{losses[-1]}")
    ms_step = statistics.median(per_step_ms[1:] or per_step_ms)
    trained, eval_s = evaluate()
    ratio = trained["block"]["recall"] / max(untrained["block"]["recall"],
                                             1e-12)
    log(f"trained {steps} steps in {t_train:.2f} s: {ms_step:.4f} ms a step "
        f"(median of chunks after the first), loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; Recall/NDCG@20 {trained} ({eval_s:.2f} s); "
        f"recall {ratio:.3f}x the untrained codebooks'")
    require(trained["block"]["recall"] > untrained["block"]["recall"],
            "training did not raise Recall@20 above the untrained codebooks'")
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "embedding_bag")}
    log(f"kernel launches on the training path: {launches} (weighted CSR "
        f"gather-sum: {weighted_per_step:g} a step)")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the training path")
    path = os.path.join(workdir, "artifact")
    art = tr.export(path)

    # parity, off the timed path
    def tables(t):
        return {k: v.detach().clone() for k, v in t.params.items()}

    short = TrainConfig(steps=32, batch_size=2048, lr=5e-3, seed=0,
                        chunk_size=chunk, sampler="device")
    runs = {}
    for backend in ("host", "fused"):
        t = Trainer(train, sketch, dataclasses.replace(short, backend=backend),
                    device=device)
        runs[backend] = (t.run(log_every=0), tables(t))
    require(runs["host"][0] == runs["fused"][0] and all(
        torch.equal(runs["host"][1][k], v)
        for k, v in runs["fused"][1].items()),
        "fused is not bitwise the host backend with the device sampler")
    ck = dataclasses.replace(short, backend="fused", steps=64,
                             ckpt_every=32,
                             ckpt_dir=os.path.join(workdir, "ckpt"))
    whole = Trainer(train, sketch, dataclasses.replace(ck, ckpt_dir=None),
                    device=device)
    whole_losses = whole.run(log_every=0)
    killed = Trainer(train, sketch, ck, device=device)
    first = killed.run(steps=32, log_every=0)
    resumed = Trainer(train, sketch, ck, device=device)
    require(resumed.maybe_resume() and resumed.step == 32,
            "no checkpoint at step 32 to resume from")
    rest = resumed.run(log_every=0)
    require(first + rest == whole_losses and all(
        torch.equal(resumed.params[k], v) for k, v in tables(whole).items()),
        "kill and resume is not bitwise the uninterrupted run")
    log("parity: 32 steps of host (device sampler) bitwise equal to fused; "
        "kill at 32 and resume bitwise equal to 64 uninterrupted steps")
    prof = profile_chunk(whole, chunk) if device == "cuda" else None
    return {"artifact": art, "trainer": tr, "path": path, "steps": steps,
            "ms_per_step": ms_step, "ms_per_step_chunks": per_step_ms,
            "seconds": t_train, "loss_first": losses[0],
            "loss_last": losses[-1], "untrained": untrained,
            "trained": trained, "recall_ratio": ratio,
            "launches": launches, "weighted_per_step": weighted_per_step,
            "profile": prof}


# ---------------------------------------------------------------------------
# phase 2b: the stream (cold-start assignment, refresh, deltas, hot swap)
# ---------------------------------------------------------------------------
def digest(a) -> str:
    import numpy as np
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:32]


def record_stream_steps(updater):
    """Wrap ``updater.apply_events``/``refresh`` so each replay step
    appends the entry ``STREAM_REFERENCE["steps"]`` pins to ``rec`` (its
    digests are filled in by :func:`close_stream_step` at the end of the
    step), and its cold-assign and refresh times and churn to
    ``timing``."""
    rec, timing = [], []
    apply_events, refresh = updater.apply_events, updater.refresh

    def apply_wrapped(*args):
        out = apply_events(*args)
        rec.append({"adopted_users": out["assign"].adopted_users,
                    "adopted_items": out["assign"].adopted_items})
        timing.append({"cold_assign_ms": out["assign"].ms})
        return out

    def refresh_wrapped(*args, **kwargs):
        stats = refresh(*args, **kwargs)
        rec[-1].update(sweeps=stats.iters, gamma=stats.gamma)
        timing[-1].update(refresh_ms=stats.ms, churn_users=stats.churn_users,
                          churn_items=stats.churn_items)
        return stats

    updater.apply_events = apply_wrapped
    updater.refresh = refresh_wrapped
    return rec, timing


def close_stream_step(rec: list, updater) -> None:
    rec[-1].update(k_users=updater.sketch.k_users,
                   k_items=updater.sketch.k_items,
                   labels=digest(updater.labels),
                   user_idx=digest(updater.sketch.user_idx),
                   item_idx=digest(updater.sketch.item_idx))


def state_ptrs(session) -> dict:
    return {f"{kind}/{k}": v.data_ptr()
            for kind, state in (("params", session.params),
                                ("statics", session.statics))
            for k, v in state.items()}


def stream_path(device: str = "cuda", stream_args=None, reference=None,
                bootstrap_steps: int = 200) -> dict:
    """The stream at full amazonbook width (``STREAM_ARGS``): BACO (d 64,
    ratio 0.25) and 200 fused training steps on the warm prefix, then
    ``replay`` of the stream's waves into a capacity-padded fused-fp32
    session (refresh every 2 steps, 40 tune steps, 8 requests of 64
    users a step) with the launcher's caps. Labels and sketch digests
    must equal ``STREAM_REFERENCE`` at every step (the JAX package's
    update-only replay; ``stream_args`` and ``reference`` replace both for
    a rehearsal at another size); swaps must allocate no device state;
    after the
    replay the int8 quantization of the final artifact is swapped into a
    padded fused and a padded dense session, which must agree, and the
    fp32 padded session must equal a fresh unpadded one."""
    import numpy as np
    import torch

    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.embedding import dequantize_params
    from repro_torch.models import lightgcn as L
    from repro_torch.stream import ReplayConfig, StreamUpdater, replay
    from repro_torch.training import TrainConfig, Trainer

    ref = reference or STREAM_REFERENCE
    args = dict(stream_args or STREAM_ARGS)
    t0 = time.perf_counter()
    stream = drifting_coclusters(**args)
    t_data = time.perf_counter() - t0
    n_edges = stream.base.n_edges + sum(s.edge_u.size for s in stream.steps)
    sizes = {"n_warm_users": stream.n_warm_users,
             "n_warm_items": stream.n_warm_items,
             "base_edges": stream.base.n_edges, "total_edges": n_edges}
    log(f"stream {args}: warm prefix {sizes}, {len(stream.steps)} waves to "
        f"{stream.n_users} x {stream.n_items} ({t_data:.1f} s on the host)")
    require(sizes == ref["stream"], f"the stream's sizes {sizes} are not "
            f"the reference's {ref['stream']}")

    engine = ClusterEngine(device=device)
    t0 = time.perf_counter()
    sketch = engine.build(stream.base, d=64, ratio=0.25)
    t_build = time.perf_counter() - t0
    boot = {"k_users": sketch.k_users, "k_items": sketch.k_items,
            "gamma": sketch.meta["gamma"], "iters": sketch.meta["iters"],
            "labels": digest(sketch.meta["joint_labels"]),
            "user_idx": digest(sketch.user_idx),
            "item_idx": digest(sketch.item_idx)}
    log(f"bootstrap BACO on the warm prefix: {t_build:.2f} s, "
        f"K_u={boot['k_users']} K_v={boot['k_items']} "
        f"gamma={boot['gamma']} iters={boot['iters']}")
    require(boot == ref["bootstrap"], f"the bootstrap sketch {boot} is not "
            f"the reference's {ref['bootstrap']}")
    tr = Trainer(stream.base, sketch,
                 TrainConfig(steps=bootstrap_steps, batch_size=2048,
                             lr=5e-3, seed=0, backend="fused",
                             chunk_size=16), device=device)
    t0 = time.perf_counter()
    losses = tr.run(log_every=0)
    sync(device)
    t_train = time.perf_counter() - t0
    log(f"bootstrap training: {bootstrap_steps} fused steps in "
        f"{t_train:.2f} s, loss {losses[0]:.5f} -> {losses[-1]:.5f}")

    caps = {"n_users": stream.n_users, "n_items": stream.n_items,
            "k_users": stream.n_users // 2, "k_items": stream.n_items // 2,
            "n_edges": n_edges}
    updater = StreamUpdater.from_trainer(tr, engine=engine, capacity=caps)
    art0 = tr.export()
    session = art0.session(k=20, capacity=caps, scorer="fused",
                           device=device)
    session.warmup(64)
    rungs = session.stats()["capacity"]
    log(f"capacity caps {caps} -> rungs {rungs} ({n_edges} stream edges)")
    alloc0, ptrs0 = session.state_allocations, state_ptrs(session)
    rec, timing = record_stream_steps(updater)
    cfg = ReplayConfig(refresh_every=2, tune_steps=40, requests_per_step=8,
                       request_batch=64)

    zero_counts()
    sync(device)
    t0 = time.perf_counter()
    report = replay(updater, stream.steps, session, cfg,
                    log=lambda line: (close_stream_step(rec, updater),
                                      log(f"  {line}")))
    sync(device)
    t_replay = time.perf_counter() - t0
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                       "embedding_bag")}
    weighted = weighted_launches()
    log(f"replay: {t_replay:.1f} s; kernel launches {launches} (weighted "
        f"CSR gather-sum {weighted})")
    for name in launches:
        require(launches[name] > 0, f"{name} never ran on the stream path")
    require(weighted > 0, "the weighted CSR gather-sum never ran on the "
            "stream path")
    tele = report["telemetry"]
    require(session.state_allocations == alloc0
            and state_ptrs(session) == ptrs0 and tele["capacity_bumps"] == 0,
            f"a swap allocated device state: "
            f"{session.state_allocations - alloc0} tensors, "
            f"{tele['capacity_bumps']} capacity bumps")
    log(f"{tele['swaps']} swaps allocated no device state (every params/"
        f"statics tensor kept its data_ptr); no capacity bump")
    for t, (got, want) in enumerate(zip(rec, ref["steps"])):
        require(got == want, f"stream step {t}: {got} is not the "
                f"reference's {want}")
    require(len(rec) == len(ref["steps"]), "replay step count differs")
    log(f"labels and sketch digests equal the reference's at all "
        f"{len(rec)} steps")

    # the final artifact: padded == fresh unpadded; int8 fused == dense
    final = report["final_artifact"]
    ids = np.arange(0, final.model["n_users"], 97)
    fresh = final.session(k=20, scorer="fused", device=device)
    got, want = session(ids), fresh(ids)
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            "the padded session's top-k is not the unpadded session's")
    quant = final.quantize()
    outs, swap_alloc = {}, 0
    for scorer in ("fused", "dense"):
        s = art0.quantize().session(k=20, capacity=caps, scorer=scorer,
                                    device=device)
        ptrs = state_ptrs(s)
        sw = s.swap(quant)
        swap_alloc += sw["state_allocations"]
        require(not sw["capacity_bumped"] and sw["state_allocations"] == 0
                and state_ptrs(s) == ptrs,
                f"the int8 swap into the {scorer} session allocated")
        outs[scorer] = [tuple(x.cpu() for x in s(ids))]
    params = {k: torch.as_tensor(v, device=device)
              for k, v in quant.serving_params().items()}
    statics = quant.statics(torch.device(device))
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    quant.mcfg())
    (vf, idf), (vd, idd) = outs["fused"][0], outs["dense"][0]
    n_diff = topk_agree(vf, idf, vd, idd, pair_scorer(
        u_all[torch.as_tensor(ids, device=device)], v_all))
    log(f"final artifact {final.content_id()}: padded fused fp32 == fresh "
        f"unpadded ({ids.size} users); int8 swapped into padded fused and "
        f"dense sessions with no allocation, agree ({n_diff} ids differ at "
        f"near-ties)")

    plain = check_stream_kernels(updater, session, ids[:64], device)

    swap = session.telemetry.swap
    st = session.stats()
    swap_ms = {"p50": swap.percentile(50), "max": swap.percentile(100)}
    lat = serve_padded_vs_unpadded(session, fresh, ids[:64], device)
    swap_parts = swap_host_ms(session, final)
    prof = profile_tune(updater, 10) if device == "cuda" else None
    steps = len(stream.steps)
    n_ref = tele["refreshes"]
    out = {
        "stream": sizes, "caps": caps, "rungs": rungs,
        "bootstrap": {**{k: boot[k] for k in ("k_users", "k_items",
                                               "gamma", "iters")},
                      "build_s": t_build, "train_s": t_train,
                      "train_steps": bootstrap_steps},
        "steps": steps, "replay_s": t_replay,
        "cold_assign_ms": [t["cold_assign_ms"] for t in timing],
        "refresh_ms": [t["refresh_ms"] for t in timing if "refresh_ms" in t],
        "refresh_sweeps": [r["sweeps"] for r in rec if "sweeps" in r],
        "tune_ms_per_step": (report["tune_total_ms"]
                             / max(cfg.tune_steps * n_ref, 1)),
        "swap_p50_ms": swap_ms["p50"], "swap_max_ms": swap_ms["max"],
        "delta_kb_mean": report["delta_bytes_mean"] / 1024,
        "request_p50_ms": st["p50_ms"], "requests": st["requests"],
        "b64_p50_ms": lat, "swap_parts_ms": swap_parts,
        "tune_profile": prof,
        "swap_allocations": session.state_allocations - alloc0 + swap_alloc,
        "capacity_bumps": tele["capacity_bumps"],
        "churn": [[t["churn_users"], t["churn_items"]] for t in timing
                  if "churn_users" in t],
        "launches": launches, "weighted_launches": weighted,
        "near_tie_ids": n_diff, "plain_checks": plain}
    return out


@contextlib.contextmanager
def plain_versions():
    """Route the LightGCN path's kernel wrappers to their plain PyTorch
    versions (``repro_torch.kernels.ref``) on device tensors, for a
    comparison on the same inputs: the propagation's weighted CSR
    gather-sum, the codebook backward's CSR gather-sum and
    ``codebook_lookup``. It fails if any kernel launched inside."""
    import importlib

    from repro_torch.kernels import ops, ref
    from repro_torch.models import lightgcn as L

    # the package exports a function of the module's name
    eb = importlib.import_module("repro_torch.kernels.embedding_bag")
    before = launch_counts()
    saved = (L.csr_gather_sum, eb.csr_gather_sum, ops.codebook_lookup)
    L.csr_gather_sum = eb.csr_gather_sum = ref.csr_gather_sum
    ops.codebook_lookup = ref.codebook_lookup
    try:
        yield
    finally:
        L.csr_gather_sum, eb.csr_gather_sum, ops.codebook_lookup = saved
    require(launch_counts() == before,
            "a kernel launched inside the plain versions")


def check_stream_kernels(updater, session, ids, device: str) -> dict:
    """The stream path's kernels against their plain versions at the
    stream's own shapes, on the same device tensors, after the replay:

      * one tuner batch on the tuner's padded device state: the BPR loss
        and both codebook gradients (codebook_lookup over the padded
        sketches; the weighted CSR gather-sum forward and backward over
        the padded edges, whose trailing segments are empty and whose
        pad edges lie past ``ptr[S]``; the codebook backward, with every
        pad sketch row folded into codebook row 0), bitwise; the pad
        codebook rows' gradients are exactly 0;
      * the padded session's ``all_embeddings``, bitwise;
      * ``fused_topk`` over the padded items with the ``-inf`` item mask
        against the plain top-k: ids agree up to near-ties
        (``topk_agree``), the ``-inf`` pattern is equal, no pad item is
        returned.

    The tuner's device statics must also equal the host padding of the
    final graph bitwise (the in-place install on the card)."""
    import numpy as np
    import torch

    from repro_torch.data.sampler import BPRSampler
    from repro_torch.embedding import dequantize_params
    from repro_torch.kernels import fused_topk, ref
    from repro_torch.models import lightgcn as L
    from repro_torch.serve.session import pad_to_capacity

    updater.tune(0)       # install the final graph into the tuner's state
    tuner, graph, sketch = updater._tuner, updater.sgraph.graph, \
        updater.sketch
    mcfg = L.from_sketch(graph, sketch, dim=int(updater.model["dim"]),
                         n_layers=int(updater.model["n_layers"]),
                         l2=float(updater.model["l2"]),
                         lookup_backend=updater.model.get("lookup_backend"))
    host = {k: v.numpy()
            for k, v in L.make_statics(graph, sketch, "cpu").items()}
    _, statics_p, mcfg_pad, caps, bumped = pad_to_capacity(
        updater.params, host, mcfg, tuner._caps)
    require(not bumped and set(statics_p) == set(tuner._statics)
            and all(torch.equal(tuner._statics[k].cpu(),
                                torch.from_numpy(v))
                    for k, v in statics_p.items()),
            "the tuner's device statics are not the host padding of the "
            "final graph")
    params, statics = tuner._params, tuner._statics
    names = sorted(params)
    u, p, n = BPRSampler(graph, tuner.batch_size, seed=0).next_batch()
    batch = {"user": torch.as_tensor(u, device=device),
             "pos": torch.as_tensor(p, device=device),
             "neg": torch.as_tensor(n, device=device)}

    def loss_and_grads():
        loss = L.bpr_loss_fn(params, statics, batch, mcfg_pad)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return [loss.detach()] + list(grads)

    def serve_embeddings():
        with torch.no_grad():
            return list(L.all_embeddings(dequantize_params(session.params),
                                         session.statics, session.mcfg))

    before, w0 = launch_counts(), weighted_launches()
    got_tune, got_emb = loss_and_grads(), serve_embeddings()
    require(launch_counts()["codebook_lookup"] > before["codebook_lookup"]
            and weighted_launches() > w0,
            "a kernel never ran in the stream checks")
    with plain_versions():
        want_tune, want_emb = loss_and_grads(), serve_embeddings()
    sync(device)
    out = {}
    for what, got, want in (
            ("tune", got_tune, want_tune),
            ("all_embeddings", got_emb, want_emb)):
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"stream {what}: kernels differ from the plain versions "
                f"(max abs err {err})")
        out[what] = err
    k_real = {"user_table": sketch.k_users, "item_table": sketch.k_items}
    for name, grad in zip(names, got_tune[1:]):
        require(not grad[k_real[name]:].any(),
                f"{name}: a pad codebook row has a nonzero gradient")
    # fused_topk over the padded items, -inf on the pads
    mask = session.statics["item_mask"]
    u_all, v_all = got_emb
    uq = u_all[torch.as_tensor(ids, device=device)].contiguous()
    got_v, got_i = fused_topk(uq, v_all, session.k, mask=mask)
    want_v, want_i = ref.fused_topk(uq, v_all, session.k, mask=mask)
    n_diff = topk_agree(got_v.cpu(), got_i.cpu(), want_v.cpu(),
                        want_i.cpu(), pair_scorer(uq, v_all, mask=mask))
    require(torch.equal(torch.isfinite(got_v), torch.isfinite(want_v)),
            "fused_topk's -inf pattern over the padded items differs")
    n_real = int(graph.n_items)
    require(int(got_i.max()) < n_real, "fused_topk returned a pad item")
    fin = torch.isfinite(want_v)
    out["fused_topk"] = float((got_v[fin] - want_v[fin]).abs().max())
    out["fused_topk_near_tie_ids"] = n_diff
    log(f"stream kernels vs plain versions at the stream's shapes: one "
        f"tuner batch of {len(u)} (loss, grads) and the padded session's "
        f"all_embeddings bitwise ({mcfg_pad.n_users} x {mcfg_pad.n_items} "
        f"padded, {int(statics['edge_u'].shape[0])} padded edges, "
        f"{int(graph.n_edges)} real); fused_topk over {v_all.shape[0]} "
        f"items ({v_all.shape[0] - n_real} -inf pads) agrees ({n_diff} ids "
        f"differ at near-ties, max abs err {out['fused_topk']})")
    return out


def serve_padded_vs_unpadded(padded, fresh, ids, device: str,
                             n: int = 9) -> dict:
    """p50 ms of ``n`` requests of the same ids on the padded session and
    on a fresh unpadded one over the same artifact, in turns (host clock
    around each call, which ends in a synchronize)."""
    import statistics
    out = {"padded": [], "unpadded": []}
    for _ in range(n):
        for name, s in (("padded", padded), ("unpadded", fresh)):
            t0 = time.perf_counter()
            s(ids)
            out[name].append((time.perf_counter() - t0) * 1e3)
    res = {k: statistics.median(v) for k, v in out.items()}
    log(f"B={len(ids)} request p50: padded {res['padded']:.4f} ms, "
        f"unpadded {res['unpadded']:.4f} ms ({n} each, in turns)")
    return res


def swap_host_ms(session, artifact) -> dict:
    """Where a swap's time goes: its host-side parts timed alone (the
    artifact's statics rebuilt on the host, then padded to the session's
    rungs), beside one more whole swap of the same artifact."""
    from repro_torch.serve.session import _host_state, _pad_state
    t0 = time.perf_counter()
    params, statics = _host_state(artifact)
    t1 = time.perf_counter()
    mcfg = dataclasses.replace(artifact.mcfg(),
                               lookup_backend=session.mcfg.lookup_backend)
    _pad_state(params, statics, mcfg, session.stats()["capacity"])
    t2 = time.perf_counter()
    whole = session.swap(artifact)
    out = {"host_state": (t1 - t0) * 1e3, "pad_state": (t2 - t1) * 1e3,
           "whole_swap": whole["ms"]}
    require(whole["state_allocations"] == 0, "a repeated swap allocated")
    log(f"swap parts (ms): {out}")
    return out


def profile_tune(updater, n: int) -> dict:
    """One ``updater.tune(n)`` under ``torch.profiler``: device time per
    tuning step by kernel, wall time per step (set-up included), idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        updater.tune(n)                     # ends in a copy to the host
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, n)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile (stream tune, {n} steps): device busy {busy:.3f} ms of "
        f"{wall_ms / n:.3f} ms a step")
    for name, ms in top:
        log(f"  {ms:8.4f} ms  {100 * ms / busy:5.1f}%  {name}")
    return {"steps": n, "device_ms_per_step": busy,
            "wall_ms_per_step": wall_ms / n,
            "idle_share": 1.0 - busy / (wall_ms / n),
            "top_kernels_ms": dict(top)}


# ---------------------------------------------------------------------------
# phase 2c: the serving front end under open-loop load
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def recorded_session_calls(calls: list):
    """Every ``RecsysSession.__call__`` inside appends ``(artifact_id,
    padded ids, (values, items))``: the device batches as the sessions
    saw them, bucket padding included."""
    import numpy as np

    from repro_torch.serve import RecsysSession
    inner = RecsysSession.__call__

    def call(self, user_ids):
        out = inner(self, user_ids)
        calls.append((self.artifact_id, np.array(user_ids), out))
        return out

    RecsysSession.__call__ = call
    try:
        yield calls
    finally:
        RecsysSession.__call__ = inner


class VersionCheck:
    """Fresh unpadded fused sessions over the served versions, and the
    near-tie rule of :func:`topk_agree` against each."""

    def __init__(self, artifacts: dict, device: str):
        from repro_torch.launch.load_bench import BUCKETS
        from repro_torch.serve import BatchDispatcher
        self.artifacts = artifacts
        self.device = device
        self.sessions = {aid: art.session(k=20, scorer="fused",
                                          device=device)
                         for aid, art in artifacts.items()}
        self.dispatchers = {aid: BatchDispatcher(s, BUCKETS)
                            for aid, s in self.sessions.items()}
        self._emb = {}
        self.near_tie_ids = 0

    def _score(self, aid, ids):
        import numpy as np
        import torch

        from repro_torch.embedding import dequantize_params
        from repro_torch.models import lightgcn as L
        if aid not in self._emb:
            art = self.artifacts[aid]
            params = {k: torch.as_tensor(v, device=self.device)
                      for k, v in art.serving_params().items()}
            statics = art.statics(torch.device(self.device))
            self._emb[aid] = (*L.all_embeddings(
                dequantize_params(params), statics, art.mcfg()), statics)
        u_all, v_all, statics = self._emb[aid]
        rows = torch.as_tensor(np.asarray(ids, np.int64), device=self.device)
        return pair_scorer(u_all[rows], v_all,
                           mask=statics.get("item_mask"))

    def agrees(self, aid, ids, vals, items, want=None) -> bool:
        """``(vals, items)`` served for ``ids`` equal the fresh session of
        version ``aid`` (``want``, its output on the same padded batch,
        else a fresh dispatch of ``ids``), bitwise or within near-ties."""
        import numpy as np
        if want is None:
            want = self.dispatchers[aid](ids)
        want = [np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                for x in want]
        vals, items = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                       for x in (vals, items))
        try:
            n = topk_agree(vals, items, want[0], want[1],
                           self._score(aid, ids))
        except SmokeFailure:
            return False
        self.near_tie_ids += n
        return True


def frontdoor_run(base, v2, shared, qps: float, device: str, versions,
                  no_shed: bool) -> dict:
    """One open-loop run of the load bench's scenario on fresh tenants:
    launch counts zeroed just before and read just after; then every
    device batch and every response checked against fresh sessions."""
    from repro_torch.launch import load_bench as LB
    fd = LB.frontdoor(base, flush_ms=2.0, queue_size=256,
                      cache_entries=1024, device=device)
    calls, submitted = [], {}
    sync(device)
    zero_counts()
    with recorded_session_calls(calls):
        rec = LB.run(fd, v2, qps=qps, duration=FRONTDOOR_DURATION_S,
                     seed=0, log=submitted)
    sync(device)
    counts = launch_counts()
    launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                       "embedding_bag")}
    launches["weighted"] = weighted_launches()
    accounted = rec["responses"] + rec["shed"] + rec["timeouts"] \
        + rec["failed"]
    require(accounted == rec["offered"] and rec["failed"] == 0,
            f"{qps} qps: arrivals unaccounted or failed: {rec}")
    require(rec["swap_mode"] == "swapped",
            f"{qps} qps: web swapped by mode {rec['swap_mode']}")
    require(rec["state_allocations_under_load"] == 0,
            f"{qps} qps: {rec['state_allocations_under_load']} device state "
            f"allocations under load")
    for name in ("codebook_lookup", "fused_topk", "embedding_bag",
                 "weighted"):
        require(launches[name] > 0,
                f"{name} never ran on the frontdoor path")

    # every device batch, at its own padded bucket
    ids_v1, ids_v2 = base.content_id(), v2.content_id()
    require({a for a, _, _ in calls} <= {ids_v1, ids_v2,
                                         shared.content_id()},
            "a session served an unknown version")
    for aid, ids, out in calls:
        require(versions.agrees(aid, ids, *out,
                                want=versions.sessions[aid](ids)),
                f"{qps} qps: a device batch of {ids.size} differs from a "
                f"fresh session of its version")
    # every response: its version, wholly, and the swap's order
    swap = submitted["swap"]
    served = {"v1": 0, "v2": 0, "either": 0, "int8": 0}
    for i, (tenant, ids, ticket) in enumerate(submitted["requests"]):
        if ticket.error() is not None:
            continue                              # a timeout, counted
        vals, items = ticket.result(timeout=60)
        if tenant != "web":
            require(versions.agrees(shared.content_id(), ids, vals, items),
                    f"{tenant} response differs from the int8 base")
            served["int8"] += 1
            continue
        is_v1 = versions.agrees(ids_v1, ids, vals, items)
        is_v2 = versions.agrees(ids_v2, ids, vals, items)
        require(is_v1 or is_v2,
                "a web response is neither wholly v1 nor wholly v2")
        if i >= swap["submitted_before"]:
            require(is_v2, "a request submitted after the swap returned "
                    "was not served by v2")
        if ticket.t_done < swap["t_start"]:
            require(is_v1, "a response resolved before the swap began "
                    "was not served by v1")
        served["either" if is_v1 and is_v2 else
               "v1" if is_v1 else "v2"] += 1
    if no_shed:
        require(rec["shed"] == 0, f"{qps} qps shed {rec['shed']} requests")
    rec["launches"] = launches
    rec["responses_checked"] = served
    rec["device_batches_checked"] = len(calls)
    log(f"frontdoor {qps:g} qps: offered {rec['offered_qps']} -> "
            f"sustained {rec['sustained_qps']}; e2e p50/p99 "
            f"{rec['e2e_p50_ms']}/{rec['e2e_p99_ms']} ms, queue p50/p99 "
            f"{rec['queue_delay_p50_ms']}/{rec['queue_delay_p99_ms']} ms; "
            f"fill {rec['batch_fill_mean']} buckets {rec['bucket_counts']}; "
            f"shed {rec['shed']} timeouts {rec['timeouts']} cache hits "
            f"{rec['cache_hits']}; swap {rec['swap_mode']} pause "
            f"{rec['swap_pause_ms']} ms (drain {rec['swap_drain_ms']}); "
            f"allocations {rec['state_allocations_under_load']}, allocator "
            f"segments +{rec['allocator_segments_under_load']}; launches "
            f"{launches}")
    log(f"frontdoor {qps:g} qps: {len(calls)} device batches and "
        f"{sum(served.values())} responses ({served}) equal fresh "
        f"sessions of their versions")
    return rec


def frontdoor_path(run: dict, device: str = "cuda",
                   extra_steps: int = 40) -> dict:
    """The serving front end (``repro_torch.frontdoor``) over the main
    path's trained export: v2 is the main path's trainer fine-tuned
    ``extra_steps`` more steps and shipped as a verified delta; then one
    open-loop run per rate in ``FRONTDOOR_RATES`` (the load bench's
    three tenants, ``web`` swapping to v2 halfway)."""
    from repro_torch.launch import load_bench as LB
    base = run["loaded"]
    t0 = time.perf_counter()
    v2 = LB.ship_v2(run["training"]["trainer"], run["training"]["artifact"],
                    extra_steps)
    require(v2.content_id() != base.content_id(), "v2 equals the base")
    shared = base.quantize()
    versions = VersionCheck({a.content_id(): a for a in (base, v2, shared)},
                            device)
    log(f"frontdoor: v2 {v2.content_id()} = base + delta after "
        f"{extra_steps} more steps ({time.perf_counter() - t0:.1f} s)")
    out = {"rates": {}}
    for i, qps in enumerate(FRONTDOOR_RATES):
        out["rates"][f"{qps:g}"] = frontdoor_run(
            base, v2, shared, qps, device, versions, no_shed=i == 0)
    out["near_tie_ids"] = versions.near_tie_ids
    out["bitwise"] = versions.near_tie_ids == 0
    log(f"frontdoor: every response checked "
        f"{'bitwise' if out['bitwise'] else 'within near-ties'} "
        f"({versions.near_tie_ids} ids at near-ties)")
    out["launches"] = {
        n: sum(r["launches"][n] for r in out["rates"].values())
        for n in ("codebook_lookup", "fused_topk", "embedding_bag",
                  "weighted")}
    return out


# ---------------------------------------------------------------------------
# phase 2d: the cluster build at scale (the 100k and 1M rungs)
# ---------------------------------------------------------------------------
def segsum_row(values, seg, n: int) -> dict:
    """The ordered W(k) sum on the card: the solver's route (a stable
    sort and one CSR gather-sum launch) bitwise against its plain version
    (``ref.segment_sum``, one ``index_add_`` per rank within a segment),
    both timed beside ``index_add_`` (atomic, so not ordered)."""
    import torch

    from repro_torch.core import solver_torch
    from repro_torch.kernels import ref
    got = solver_torch.segment_sum_ordered(values, seg, n)
    want = ref.segment_sum(values, seg, n)
    require(torch.equal(got, want),
            "the ordered W(k) sum is not bitwise its plain version")
    m = int(seg.shape[0])
    steps = int(torch.bincount(seg, minlength=n).max()) if m else 0
    # values and labels read, sums written; one add per value
    bms, by = bound(4 * m + 8 * m + 4 * n, m)
    return {"shape": f"M={m} segments={n}", "plain_steps": steps,
            "ms": time_ms(lambda: solver_torch.segment_sum_ordered(
                values, seg, n)),
            "plain_ms": time_ms(lambda: ref.segment_sum(values, seg, n),
                                iters=5, warmup=1),
            "library_ms": time_ms(lambda: torch.zeros(
                n, device=values.device).index_add_(0, seg, values)),
            "bound_ms": bms, "bound_by": by,
            "max_abs_err": float((got - want).abs().max()) if n else 0.0}


def scale_path(device: str = "cuda", rungs=("100k", "1m"),
               reference=None, blocks=None) -> dict:
    """The scale ladder's rungs through ``repro_torch.launch.cluster_scale``
    (``planted_coclusters``, average degree 8, gamma 0.5, 8 sweeps). Each
    rung: the streamed solve at its two block sizes on a graph no
    in-memory solve has touched, then the in-memory "torch" solve (its
    peak from a reset, with the device edge lists dropped before and
    after); at 100k also "torch_hostloop" and the minhash cold-assign
    experiment. Labels and sweeps must be equal across the solves and
    the reference's (``SCALE_REFERENCE``), and at the smaller block size
    the streamed peak device bytes must lie below the in-memory solve's.
    Launch counts are zeroed just before the first solve and read just
    after the last; the CSR gather-sum (the ordered W(k) sums) must have
    run. Then the ordered W(k) sum on each rung's final labels is held
    bitwise against its plain version and timed."""
    import numpy as np
    import torch

    from repro_torch.core import make_weights
    from repro_torch.core.metrics import bipartite_modularity
    from repro_torch.launch import cluster_scale as cs

    ref = reference or SCALE_REFERENCE
    blocks = blocks or SCALE_BLOCKS
    graphs = {}
    for rung in rungs:
        g, build_s = cs.build_rung(rung)
        graphs[rung] = (g, build_s, make_weights(g, "hws"))
        log(f"scale {rung}: {g.n_users} x {g.n_items}, {g.n_edges} edges "
            f"(built in {build_s:.2f} s on the host)")
    zero_counts()
    out, finals = {}, {}
    for rung in rungs:
        g, build_s, (wu, wv) = graphs[rung]
        rec = {"n_nodes": g.n_nodes, "n_edges": g.n_edges,
               "build_s": build_s, "streamed": {}}
        labels = {}
        for be in blocks[rung]:
            lab, it, st, sec = cs.solve_streamed(g, wu, wv, be, device)
            labels[f"streamed/{be}"] = (lab, it)
            rec["streamed"][str(be)] = {**st, "solve_s": sec}
            log(f"scale {rung}: streamed block_edges={be}: {it} sweeps in "
                f"{sec:.3f} s (fastest sweep {st['sweep_ms']:.3f} ms, "
                f"{st['blocks_per_s']:.1f} blocks/s, "
                f"{st['n_blocks_user']}+{st['n_blocks_item']} blocks padded "
                f"to {st['block_pad_user']}/{st['block_pad_item']}), peak "
                f"{st['peak_device_bytes']} bytes "
                f"[{st['peak_bytes_source']}]")
        base = int(torch.cuda.memory_allocated()) if device == "cuda" else 0
        lab, it, sec, peak = cs.solve_inmem(g, wu, wv, device)
        labels["torch"] = (lab, it)
        rec["inmem"] = {"sweeps": it, "solve_s": sec,
                        "peak_device_bytes": peak,
                        "allocated_before_bytes": base}
        log(f"scale {rung}: in-memory torch: {it} sweeps in {sec:.3f} s, "
            f"peak {peak} bytes ({base} allocated before)")
        if rung == "100k":
            lab, it, sec, _ = cs.solve_inmem(g, wu, wv, device,
                                             solver="torch_hostloop")
            labels["torch_hostloop"] = (lab, it)
            rec["hostloop"] = {"sweeps": it, "solve_s": sec}
            log(f"scale {rung}: torch_hostloop: {it} sweeps in {sec:.3f} s")
        lab0, it0 = labels["torch"]
        for name, (lab, it) in labels.items():
            require(np.array_equal(lab, lab0) and it == it0,
                    f"scale {rung}: {name} differs from the in-memory solve")
        got = {"n_edges": g.n_edges, "labels": digest(lab0.astype(np.int32)),
               "iters": it0, "modularity": bipartite_modularity(g, lab0)}
        require(got == ref[rung], f"scale {rung}: {got} is not the "
                f"reference's {ref[rung]}")
        small = rec["streamed"][str(min(blocks[rung]))]["peak_device_bytes"]
        if device == "cuda":
            require(small < rec["inmem"]["peak_device_bytes"],
                    f"scale {rung}: streamed peak {small} bytes is not below "
                    f"the in-memory solve's {rec['inmem']['peak_device_bytes']}")
        rec["reference"] = got
        log(f"scale {rung}: {len(labels)} solves equal, and equal to the "
            f"reference (labels {got['labels']}, {it0} sweeps, modularity "
            f"{got['modularity']})")
        if rung == "100k":
            t0 = time.perf_counter()
            rec["cold"] = c = cs.cold_experiment(g, lab0, device)
            log(f"scale {rung}: cold-assign {c['n_cold_users']} users in "
                f"{time.perf_counter() - t0:.2f} s: exact {c['exact_ms']:.2f}"
                f" ms, minhash {c['minhash_total_ms']:.2f} ms (index "
                f"{c['cand_ms']:.2f} ms), recall {c['minhash_recall']}, "
                f"{c['mean_candidates']:.1f} candidates of {c['n_labels']} "
                f"labels")
        finals[rung] = lab0
        out[rung] = rec
    sync(device)
    counts = launch_counts()
    launches = {"embedding_bag": counts["embedding_bag"]}
    log(f"kernel launches on the scale path: {launches}")
    require(launches["embedding_bag"] > 0,
            "embedding_bag never ran on the scale path")
    if device == "cuda":
        for rung in rungs:
            g, _, (wu, wv) = graphs[rung]
            lab = torch.as_tensor(finals[rung], dtype=torch.int64,
                                  device=device)
            rows = {}
            for side, w, seg in (
                    ("items", wv, lab[g.n_users:]),
                    ("users", wu, lab[:g.n_users])):
                rows[side] = segsum_row(
                    torch.as_tensor(np.asarray(w, np.float32),
                                    device=device), seg, g.n_nodes)
            steps = rows["items"]["plain_steps"] + rows["users"]["plain_steps"]
            out[rung]["segment_sum"] = {
                **rows, "plain_steps_per_sweep": steps,
                "ms_per_sweep": rows["items"]["ms"] + rows["users"]["ms"],
                "plain_ms_per_sweep": (rows["items"]["plain_ms"]
                                       + rows["users"]["plain_ms"])}
            log(f"scale {rung}: ordered W(k) sums of the final labels "
                f"bitwise their plain version: "
                f"{out[rung]['segment_sum']['ms_per_sweep']:.4f} ms a sweep "
                f"(plain: {steps} steps, "
                f"{out[rung]['segment_sum']['plain_ms_per_sweep']:.4f} ms)")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 2e: the paper's comparison (ETC baselines and parameter accounting)
# ---------------------------------------------------------------------------
def baselines_path(run: dict, workdir: str, device: str = "cuda",
                   steps: int = BASELINE_TRAIN_STEPS,
                   check_dataset: str = "gowalla_s") -> dict:
    """The baselines of ``BASELINE_METHODS`` built on the main path's
    graph at budget 0.25 x nodes (the train launcher's), ``lp``/``lpab``
    through the GPU solver; their K and parameters against full. At
    ``check_dataset`` the GPU ``lp``/``lpab`` sketches must equal the
    CPU port's. Then ``double`` (2-hot on both sides) as the train
    launcher runs it: ``steps`` fused steps at batch 2,048,
    Recall/NDCG@20 on 4,096 test users beside the main path's BACO,
    export, int8 quantization (``n_params``/``serving_nbytes``; int8
    must be smaller), 13 fused requests against a fresh session. Launch
    counts are zeroed before training and before serving and read after
    each; codebook_lookup (items H = 2), the CSR gather-sum and
    fused_topk must have run. The items' H = 2 lookup is then held
    against its plain version and timed."""
    import numpy as np
    import torch

    from repro_torch.core import build_sketch
    from repro_torch.data import paperlike_dataset
    from repro_torch.kernels import codebook_lookup, ref
    from repro_torch.serve import CompressedArtifact, RecsysSession
    from repro_torch.training import TrainConfig, Trainer

    train, test = run["train"], run["test"]
    budget = int(0.25 * train.n_nodes)
    full = (train.n_users + train.n_items) * 64
    sketches, builds = {}, {}
    for name in BASELINE_METHODS:
        t0 = time.perf_counter()
        sk = build_sketch(name, train, budget, device=device)
        sync(device)
        sec = time.perf_counter() - t0
        sketches[name] = sk
        builds[name] = {"k_users": sk.k_users, "k_items": sk.k_items,
                        "hot": [int(sk.user_idx.shape[1]),
                                int(sk.item_idx.shape[1])],
                        "n_params": sk.n_params(64), "full_params": full,
                        "build_s": sec}
        log(f"baseline {name}: K_u={sk.k_users} K_v={sk.k_items} "
            f"(H {builds[name]['hot']}), {sk.n_params(64)} params = "
            f"{sk.n_params(64) / full:.4f} of full, built in {sec:.2f} s")
    bk = run["sketch"]
    builds["baco"] = {"k_users": bk.k_users, "k_items": bk.k_items,
                      "n_params": bk.n_params(64), "full_params": full,
                      "build_s": run["cluster_s"]}
    _, _, _, small, _ = paperlike_dataset(check_dataset, seed=0)
    b_small = int(0.25 * small.n_nodes)
    for name in ("lp", "lpab"):
        a = build_sketch(name, small, b_small, device=device)
        b = build_sketch(name, small, b_small, device="cpu")
        require(np.array_equal(a.user_idx, b.user_idx)
                and np.array_equal(a.item_idx, b.item_idx)
                and a.meta["iters"] == b.meta["iters"],
                f"{check_dataset}: the GPU {name} sketch is not the CPU's")
    log(f"{check_dataset}: GPU lp and lpab sketches equal the CPU port's")

    sk = sketches["double"]
    cfg = TrainConfig(steps=steps, batch_size=2048, lr=5e-3, seed=0,
                      backend="fused", chunk_size=16)
    tr = Trainer(train, sk, cfg, device=device)
    zero_counts()
    sync(device)
    t0 = time.perf_counter()
    losses = tr.run(log_every=0)
    sync(device)
    t_train = time.perf_counter() - t0
    counts = launch_counts()
    train_launches = {n: counts[n] for n in ("codebook_lookup",
                                             "embedding_bag")}
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"double: the loss did not fall: {losses[0]} -> {losses[-1]}")
    metrics = tr.evaluate(test, max_users=4096, topk_backend="block")
    baco = run["training"]["trained"]["block"]
    log(f"double: {steps} fused steps in {t_train:.2f} s, loss "
        f"{losses[0]:.5f} -> {losses[-1]:.5f}; Recall/NDCG@20 {metrics} "
        f"(BACO after {run['training']['steps']} steps: {baco})")
    art = tr.export(os.path.join(workdir, "double"))
    loaded = CompressedArtifact.load(os.path.join(workdir, "double"))
    require(loaded.content_id() == art.content_id(),
            "double: content_id changed across save/load")
    q = loaded.quantize()
    acct = {"n_params_fp32": loaded.n_params(),
            "serving_nbytes_fp32": loaded.serving_nbytes(),
            "n_params_int8": q.n_params(),
            "serving_nbytes_int8": q.serving_nbytes(),
            "compressed": loaded.compressed}
    require(loaded.n_params() == sk.n_params(64),
            "double: the artifact's n_params is not the sketch's")
    require(acct["serving_nbytes_int8"] < acct["serving_nbytes_fp32"],
            f"double: int8 is not smaller than fp32: {acct}")
    log(f"double export: {acct}")

    rng = np.random.default_rng(1)
    sizes = [1, 8, 64, 512] + [int(x) for x in rng.integers(1, 513, 9)]
    batches = [rng.integers(0, train.n_users, x) for x in sizes]
    session = RecsysSession.from_artifact(loaded, k=20, scorer="fused",
                                          device=device)
    zero_counts()
    t0 = time.perf_counter()
    outs = [session(b) for b in batches]
    sync(device)
    t_serve = time.perf_counter() - t0
    counts = launch_counts()
    serve_launches = {n: counts[n] for n in ("codebook_lookup", "fused_topk",
                                             "embedding_bag")}
    fresh = RecsysSession.from_artifact(loaded, k=20, scorer="fused",
                                        device=device)
    for b, (v, i) in zip(batches, outs):
        fv, fi = fresh(b)
        require(v.shape == (b.size, 20) and torch.isfinite(v).all(),
                "double: bad top-k values")
        require(torch.equal(v, fv) and torch.equal(i, fi),
                "double: a served request differs from a fresh session's")
    log(f"double: {len(batches)} fused requests in {t_serve:.3f} s, "
        f"bitwise a fresh session's; launches training {train_launches}, "
        f"serving {serve_launches}")
    for phase, launched in (("training", train_launches),
                            ("serving", serve_launches)):
        for name, n in launched.items():
            require(n > 0, f"{name} never ran on the baselines {phase} path")
    row = None
    if device == "cuda":
        z = torch.as_tensor(loaded.params["item_table"], device=device)
        ix = torch.as_tensor(sk.item_idx, dtype=torch.int32, device=device)
        got = codebook_lookup(z, ix, binary=True)
        want = ref.codebook_lookup(z, ix, binary=True)
        require(torch.equal(got, want), "codebook_lookup (items H = 2) is "
                "not bitwise the plain version")
        b, h = ix.shape
        bms, by = bound(4 * (ix.numel() + z.numel() + b * z.shape[1]),
                        b * h * z.shape[1])
        ixl = ix.long()
        row = {"shape": f"B={b} H={h} K={z.shape[0]} d={z.shape[1]}",
               "ms": time_ms(lambda: codebook_lookup(z, ix, binary=True)),
               "plain_ms": time_ms(lambda: ref.codebook_lookup(
                   z, ix, binary=True)),
               "library_ms": time_ms(lambda: z[ixl].sum(1)),
               "bound_ms": bms, "bound_by": by,
               "max_abs_err": float((got - want).abs().max())}
        log(f"codebook_lookup items H=2 {row['shape']}: bitwise equal; {row}")
    return {"budget": budget, "builds": builds,
            "double": {"steps": steps, "train_s": t_train,
                       "loss_first": losses[0], "loss_last": losses[-1],
                       "metrics": metrics, "baco_metrics": baco, **acct,
                       "serve_s": t_serve, "requests": len(batches)},
            "launches": {
                "training": train_launches, "serving": serve_launches,
                "codebook_lookup": (train_launches["codebook_lookup"]
                                    + serve_launches["codebook_lookup"]),
                "embedding_bag": (train_launches["embedding_bag"]
                                  + serve_launches["embedding_bag"]),
                "fused_topk": serve_launches["fused_topk"]},
            "codebook_items_h2": row}


# ---------------------------------------------------------------------------
# phase 3: the embedding layer's entry points
# ---------------------------------------------------------------------------
def embedding_inputs(run: dict, device: str) -> dict:
    """The main path's trained codebooks, sketch and training bags as
    tensors on ``device``, int8 codebooks beside them."""
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
# phase 4: the kernel bench (dot_interaction's and flash_attention's path)
# ---------------------------------------------------------------------------
def bench_path(device: str = "cuda", fast: bool = False) -> dict:
    """Drives ``repro_torch.launch.kernel_bench`` as a user would
    (``device="cpu"`` with ``fast=True`` rehearses it without a GPU)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch import kernel_bench

    t0 = time.perf_counter()
    zero_counts()
    rows = kernel_bench.run(fast=fast, device=device)
    lookup = kernel_bench.bench_backends(device=device)
    fused = kernel_bench.bench_fused(device=device)
    # the bench's attention is f32 (the CUDA-core route); a qwen1.5-32b
    # layer's prefill attention in its bf16 takes the tensor-core route
    b, h, s, d = (1, 40, 4096, 128) if not fast else (1, 2, 256, 128)
    g = torch.Generator(device=device).manual_seed(6)
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=True)
    require(out.shape == q.shape and bool(torch.isfinite(out).all()),
            "kernel bench: bf16 attention gave non-finite values")
    sync(device)
    launches = launch_counts()
    routes = flash_routes()
    seconds = time.perf_counter() - t0
    metrics = kernel_bench.sweep_metrics(lookup, fused)
    log(f"kernel bench: {seconds:.1f} s; kernel launches {launches}; "
        f"flash_attention by route {routes}")
    err = float(dict(kv.split("=") for kv in rows[-1][2].split(";"))[
        "max_abs_err"])
    require(rows[-1][0] == "kernel/flash_attention_maxerr" and err < 1e-4,
            f"kernel bench: flash_attention differs from ref.mha by {err}")
    require(metrics["lookup_errors"]["value"] == 0,
            "kernel bench: a lookup backend failed")
    # the one refusal expected: the fused kernels' k cap, on the card
    for r in fused:
        cap = re.search(r"k <= (\d+), got k=(\d+)", r.get("error", ""))
        require("error" not in r or (
            device == "cuda" and r["variant"].startswith("fused")
            and cap is not None and int(cap[2]) > int(cap[1])),
            f"kernel bench: the fused sweep failed: {r}")
    for name in ("dot_interaction", "flash_attention"):
        require(launches[name] > 0, f"{name} never ran on the kernel "
                f"bench's path")
    for name, n in routes.items():
        require(device != "cuda" or n > 0, f"flash_attention's {name} route "
                f"never ran on the kernel bench's path")
    return {"rows": [{"name": n, "us_per_call": us, "derived": d}
                     for n, us, d in rows],
            "metrics": metrics, "launches": launches,
            "flash_routes": routes, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 5: each kernel against its plain version
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
    # edge cases: duplicates within rows, H = 1..5 and 40 (a row of more
    # than 32 indices), binary on and off, widths with scalar and float2 /
    # float4 lanes, a codebook not 16-byte aligned, B not a multiple of a
    # strip, B = 0
    g = torch.Generator(device="cpu").manual_seed(0)
    n_cases = 0
    for h in (1, 2, 3, 5, 40):
        for d in (1, 3, 64, 129):
            flat = torch.randn(97 * d + 1, generator=g).to(dev)
            ix = torch.randint(0, 97, (1001, h), generator=g,
                               dtype=torch.int32)
            if h > 1:
                ix[::3, h - 1] = ix[::3, 0]           # forced duplicates
            ix = ix.to(dev)
            for z in (flat[:97 * d].view(97, d), flat[1:].view(97, d)):
                for binary in (False, True):
                    got = codebook_lookup(z, ix, binary=binary)
                    want = ref.codebook_lookup(z, ix, binary=binary)
                    require(torch.equal(got, want),
                            f"codebook_lookup H={h} d={d} binary={binary} "
                            f"differs")
                    n_cases += 1
    empty = codebook_lookup(z, ix[:0], binary=True)
    require(empty.shape == (0, z.shape[1]), "codebook_lookup B=0")
    log(f"codebook_lookup edge cases ({n_cases}: H 1..5 and 40, d 1..129, "
        f"duplicates, binary on/off, unaligned codebook, B=0): bitwise "
        f"equal")
    main = rows["users"]
    return {"name": "codebook_lookup", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/codebook_lookup.cu",
            "replaces": "src/repro/kernels/codebook_lookup.py:98",
            "launches": (run["launches"]["codebook_lookup"]
                         + run["training"]["launches"]["codebook_lookup"]
                         + run["stream"]["launches"]["codebook_lookup"]
                         + run["frontdoor"]["launches"]["codebook_lookup"]
                         + run["baselines"]["launches"]["codebook_lookup"]),
            "launches_by_path": {
                "serving": run["launches"]["codebook_lookup"],
                "training": run["training"]["launches"]["codebook_lookup"],
                "stream": run["stream"]["launches"]["codebook_lookup"],
                "frontdoor":
                    run["frontdoor"]["launches"]["codebook_lookup"],
                "baselines":
                    run["baselines"]["launches"]["codebook_lookup"]},
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main["shape"], "items": rows["items"],
            "items_h2": run["baselines"]["codebook_items_h2"]}


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
        one, two = fused_topk(u, v_all, k), fused_topk(u, v_all, k)
        require(torch.equal(one[0], two[0]) and torch.equal(one[1], two[1]),
                f"fused_topk B={b}: two calls differ")
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
            "launches": (run["launches"]["fused_topk"]
                         + run["stream"]["launches"]["fused_topk"]
                         + run["frontdoor"]["launches"]["fused_topk"]
                         + run["baselines"]["launches"]["fused_topk"]),
            "launches_by_path": {
                "serving": run["launches"]["fused_topk"],
                "stream": run["stream"]["launches"]["fused_topk"],
                "frontdoor": run["frontdoor"]["launches"]["fused_topk"],
                "baselines": run["baselines"]["launches"]["fused_topk"]},
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
                again = fused_topk_codebook(u, z, sk, k, scale=scale,
                                            mask=mask)
                require(torch.equal(got[0], again[0])
                        and torch.equal(got[1], again[1]),
                        f"fused_topk_codebook {side} B={b}: two calls differ")
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


def csr_ptr(sorted_rows, n: int):
    """int64 [n + 1] CSR boundaries of the runs of 0..n-1 in
    ``sorted_rows`` (what the bag and scatter wrappers build)."""
    import torch
    return torch.searchsorted(sorted_rows,
                              torch.arange(n + 1, device=sorted_rows.device))


def csr_cases(emb: dict, table, seed: int = 11) -> dict:
    """The CSR gather-sum's (src, idx, ptr) as the embedding path hands
    them to the kernel: the bag forward (every user's bag of training
    items over ``table``), the bag backward (``scatter_rows`` into the
    item rows) and the codebook gradients of both sides (``scatter_rows``
    into K_u and K_v rows, binary-Y duplicates dropped), with seeded
    normal cotangents."""
    import torch

    from repro_torch.kernels import ref

    dev = table.device
    d = table.shape[1]
    g = torch.Generator(device="cpu").manual_seed(seed)
    vals, segs = emb["values"], emb["segments"]
    n_users, n_items = emb["n_users"], emb["n_items"]
    cases = {"forward": (table, vals, csr_ptr(segs, n_users))}
    w = torch.randn(n_users, d, generator=g).to(dev)
    dest, perm = torch.sort(vals.long(), stable=True)
    cases["bag_backward"] = (w, segs[perm].int(), csr_ptr(dest, n_items))
    for side in ("users", "items"):
        sk = emb[side]["sketch"]
        b, h = sk.shape
        k_rows = emb[side]["z"].shape[0]
        cot = torch.randn(b, d, generator=g).to(dev)
        dest = sk.reshape(-1).long()
        src = torch.arange(b * h, device=dev) // h
        if h > 1:
            keep = ref.dedup_keep_mask(sk).reshape(-1)
            dest, src = dest[keep], src[keep]
        dest, perm = torch.sort(dest, stable=True)
        cases[f"codebook_{side}"] = (cot, src[perm].int(),
                                     csr_ptr(dest, k_rows))
    return cases


def skewed_csr(rows: int, n_src: int, g, device, longest: int = 4000,
               mid: int = 200):
    """(idx int32, ptr int64) of power-law-like bags over ``n_src``
    source rows: ``longest`` values in the first and the last bag,
    ``mid`` bags of 300-600 values at random rows, the rest 0-3 values."""
    import torch
    lens = torch.randint(0, 4, (rows,), generator=g)
    pos = torch.randperm(rows - 2, generator=g)[:mid] + 1
    lens[pos] = torch.randint(300, 601, (len(pos),), generator=g)
    lens[0] = lens[-1] = longest
    ptr = torch.zeros(rows + 1, dtype=torch.int64)
    ptr[1:] = torch.cumsum(lens, 0)
    idx = torch.randint(0, n_src, (int(ptr[-1]),), generator=g,
                        dtype=torch.int32)
    return idx.to(device), ptr.to(device)


def csr_row(src, idx, ptr) -> dict:
    """Times and bound of one CSR gather-sum call; the library call is
    ``zeros(S, d).index_add_(0, row_of_each_value, src[idx])``."""
    import torch

    from repro_torch.kernels import csr_gather_sum, ref

    n_seg = ptr.numel() - 1
    n, d = src.shape
    nnz = idx.numel()
    bytes_moved = 4 * src.numel() + 4 * nnz + 8 * (n_seg + 1) + 4 * n_seg * d
    bms, by = bound(bytes_moved, nnz * d)
    seg = torch.repeat_interleave(torch.arange(n_seg, device=src.device),
                                  ptr[1:] - ptr[:-1])
    idl = idx.long()
    lens = ptr[1:] - ptr[:-1]
    return {"shape": f"nnz={nnz} S={n_seg} N={n} d={d} "
                     f"longest={int(lens.max())}",
            "ms": time_ms(lambda: csr_gather_sum(src, idx, ptr)),
            "plain_ms": time_ms(lambda: ref.csr_gather_sum(src, idx, ptr),
                                iters=5),
            "library_ms": time_ms(lambda: torch.zeros(
                n_seg, d, device=src.device).index_add_(0, seg, src[idl])),
            "bound_ms": bms, "bound_by": by}


def check_embedding_bag(run: dict, emb_run: dict) -> dict:
    import torch

    from repro_torch.kernels import csr_gather_sum, ref
    from repro_torch.kernels.embedding_bag import scatter_rows

    emb = emb_run["emb"]
    cases = csr_cases(emb, emb_run["v0"])
    max_err = 0.0
    rows = {}
    for name, (src, idx, ptr) in cases.items():
        got = csr_gather_sum(src, idx, ptr)
        want = ref.csr_gather_sum(src, idx, ptr)
        require(torch.equal(got, want),
                f"embedding_bag kernel ({name}) is not bitwise its plain "
                f"version")
        require(torch.equal(got, csr_gather_sum(src, idx, ptr)),
                f"embedding_bag kernel ({name}): two calls differ")
        max_err = max(max_err, float((got - want).abs().max()))
        rows[name] = csr_row(src, idx, ptr)
        log(f"embedding_bag {name} {rows[name]['shape']}: bitwise; "
            f"{rows[name]}")
    # the backward case is what scatter_rows hands the kernel
    w = cases["bag_backward"][0]
    require(torch.equal(scatter_rows(w, emb["values"], emb["segments"],
                                     emb["n_items"]),
                        ref.embedding_bag(w, emb["segments"], emb["values"],
                                          emb["n_items"])),
            "scatter_rows is not bitwise the plain bag backward")
    # edge cases: skewed bags (4,000 values at the first and last rows,
    # 200 of 300-600, the rest 0-3), widths with scalar and float2 /
    # float4 lanes and column tiles, a source not 16-byte aligned, all
    # bags empty, no rows
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(4)
    n_cases = 0
    for d in (1, 3, 50, 64, 129, 256, 600):
        idx, ptr = skewed_csr(3000, 1000, g, dev)
        flat = torch.randn(1000 * d + 1, generator=g).to(dev)
        for src in (flat[:1000 * d].view(1000, d),
                    flat[1:].view(1000, d)):          # 4 bytes off
            got = csr_gather_sum(src, idx, ptr)
            require(torch.equal(got, ref.csr_gather_sum(src, idx, ptr)),
                    f"embedding_bag skewed bags d={d} differ")
            n_cases += 1
    src = torch.randn(10, 64, device=dev)
    for idx, ptr in ((torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(7, dtype=torch.int64, device=dev)),
                     (torch.zeros(0, dtype=torch.int32, device=dev),
                      torch.zeros(1, dtype=torch.int64, device=dev))):
        got = csr_gather_sum(src, idx, ptr)
        require(got.shape == (ptr.numel() - 1, 64) and not got.any(),
                "embedding_bag: empty bags are not zero rows")
        n_cases += 1
    log(f"embedding_bag edge cases ({n_cases}: skewed bags, d 1..600, "
        f"unaligned source, empty bags, no rows): bitwise equal")
    weighted = check_weighted(run)
    main = rows["forward"]
    path_launches = {
        "serving": run["launches"]["embedding_bag"],
        "training": run["training"]["launches"]["embedding_bag"],
        "embedding_layer": emb_run["launches"]["embedding_bag"],
        "stream": run["stream"]["launches"]["embedding_bag"],
        "frontdoor": run["frontdoor"]["launches"]["embedding_bag"],
        "cluster": run["cluster_launches"],
        "scale": run["scale"]["launches"]["embedding_bag"],
        "baselines": run["baselines"]["launches"]["embedding_bag"]}
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag.py:56",
            "launches": sum(path_launches.values()),
            "launches_by_path": path_launches,
            "weighted_per_train_step": run["training"]["weighted_per_step"],
            "weighted_per_request": run["weighted_per_request"],
            "max_abs_err": max_err,
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "library_ms", "shape")},
            "backward": {k: rows[k] for k in rows if k != "forward"},
            "weighted": weighted,
            "segment_sum": {r: run["scale"][r]["segment_sum"]
                            for r in run["scale"]
                            if "segment_sum" in run["scale"].get(r, {})}}


def cumsum_route(src_t, idx, w, ptr):
    """The propagation's segment sum as the port computed it before the
    weighted kernel (a yardstick only): layers kept as [d, n], the edge
    rows gathered and weighted as columns, a cumsum along the edges and a
    boundary difference."""
    import torch
    c = torch.cumsum(torch.nn.functional.pad(src_t[:, idx] * w, (1, 0)),
                     dim=1)
    return c[:, ptr[1:]] - c[:, ptr[:-1]]


def weighted_row(src, idx, w, ptr) -> dict:
    """Times and bound of one weighted CSR gather-sum call: the bound
    reads the source table once, idx, w and ptr, and writes out; the
    library call is ``zeros(S, d).index_add_(0, seg, src[idx] * w)``, and
    ``cumsum_ms`` the previous cumsum route."""
    import torch

    from repro_torch.kernels import csr_gather_sum, ref

    n_seg = ptr.numel() - 1
    n, d = src.shape
    nnz = idx.numel()
    bytes_moved = (4 * src.numel() + 8 * nnz + 8 * (n_seg + 1)
                   + 4 * n_seg * d)
    bms, by = bound(bytes_moved, 2 * nnz * d)
    seg = torch.repeat_interleave(torch.arange(n_seg, device=src.device),
                                  ptr[1:] - ptr[:-1])
    idl = idx.long()
    src_t = src.T.contiguous()
    lens = ptr[1:] - ptr[:-1]
    return {"shape": f"nnz={nnz} S={n_seg} N={n} d={d} "
                     f"longest={int(lens.max())} weighted",
            "ms": time_ms(lambda: csr_gather_sum(src, idx, ptr, w)),
            "plain_ms": time_ms(
                lambda: ref.csr_gather_sum(src, idx, ptr, w), iters=5),
            "library_ms": time_ms(lambda: torch.zeros(
                n_seg, d, device=src.device).index_add_(
                0, seg, src[idl] * w[:, None])),
            "cumsum_ms": time_ms(lambda: cumsum_route(src_t, idl, w, ptr)),
            "bound_ms": bms, "bound_by": by}


def check_weighted(run: dict, device: str = "cuda") -> dict:
    """The weighted CSR gather-sum (the LightGCN propagation) bitwise
    against its plain version at the propagation's two shapes, through
    ``_Propagate`` forward and backward, and on edge cases; timed at both
    shapes."""
    import torch

    from repro_torch.kernels import csr_gather_sum, ref
    from repro_torch.models import lightgcn as L

    dev = torch.device(device)
    train = run["train"]
    statics = run["loaded"].statics(dev)
    user_side, item_side = L._kernel_edges(statics)
    g = torch.Generator(device="cpu").manual_seed(12)
    cu = torch.randn(train.n_users, 64, generator=g).to(dev)
    cv = torch.randn(train.n_items, 64, generator=g).to(dev)
    rows = {}
    for name, src, (idx, w, ptr) in (("user_side", cv, user_side),
                                     ("item_side", cu, item_side)):
        got = csr_gather_sum(src, idx, ptr, w)
        require(torch.equal(got, ref.csr_gather_sum(src, idx, ptr, w)),
                f"weighted CSR gather-sum ({name}) is not bitwise its plain "
                f"version")
        require(torch.equal(got, csr_gather_sum(src, idx, ptr, w)),
                f"weighted CSR gather-sum ({name}): two calls differ")
        rows[name] = weighted_row(src, idx, w, ptr)
        log(f"embedding_bag weighted {name} {rows[name]['shape']}: bitwise; "
            f"{rows[name]}")
    # through the propagation's autograd function, forward and backward
    a, b = cu.clone().requires_grad_(True), cv.clone().requires_grad_(True)
    nu, nv = L._Propagate.apply(a, b, statics)
    gu = torch.randn(nu.shape, generator=g).to(dev)
    gv = torch.randn(nv.shape, generator=g).to(dev)
    d_cu, d_cv = torch.autograd.grad((nu * gu).sum() + (nv * gv).sum(),
                                     [a, b])
    plain = {"nu": ref.csr_gather_sum(cv, *user_side[:1], user_side[2],
                                      user_side[1]),
             "nv": ref.csr_gather_sum(cu, item_side[0], item_side[2],
                                      item_side[1]),
             "d_cv": ref.csr_gather_sum(gu, item_side[0], item_side[2],
                                        item_side[1]),
             "d_cu": ref.csr_gather_sum(gv, user_side[0], user_side[2],
                                        user_side[1])}
    for name, got in (("nu", nu), ("nv", nv), ("d_cu", d_cu),
                      ("d_cv", d_cv)):
        require(torch.equal(got, plain[name]),
                f"_Propagate {name} is not bitwise the plain version")
    log("_Propagate forward and backward at full width: bitwise the plain "
        "version")
    # edge cases: empty rows, w = 0 and -0.0, negative weights, rows of
    # more than 32 values, one row of 100,000 values; widths of scalar,
    # float2 and float4 lanes, and a column tile
    n_cases = 0
    for d in (1, 3, 64, 129, 600):
        idx, ptr = skewed_csr(3000, 1000, g, dev)
        w = torch.randn(idx.numel(), generator=g)
        w[::5] = 0.0
        w[::7] = -0.0
        w = w.to(dev)
        src = torch.randn(1000, d, generator=g).to(dev)
        require(torch.equal(csr_gather_sum(src, idx, ptr, w),
                            ref.csr_gather_sum(src, idx, ptr, w)),
                f"weighted skewed bags d={d} differ")
        n_cases += 1
    src = torch.randn(1000, 64, generator=g).to(dev)
    idx = torch.randint(0, 1000, (100_000,), generator=g,
                        dtype=torch.int32).to(dev)
    w = torch.randn(100_000, generator=g).to(dev)
    ptr = torch.tensor([0, 100_000, 100_000], device=dev)
    require(torch.equal(csr_gather_sum(src, idx, ptr, w),
                        ref.csr_gather_sum(src, idx, ptr, w)),
            "weighted row of 100,000 values differs")
    zero = csr_gather_sum(src, idx, ptr, torch.full_like(w, -0.0))
    require(not zero.any() and not zero.signbit().any(),
            "-0.0 weights do not sum to +0.0")
    log(f"weighted edge cases ({n_cases + 2}: skewed bags with zero, -0.0 "
        f"and negative weights, d 1..600, one row of 100,000 values, "
        f"all -0.0 weights): bitwise equal")
    return rows


def check_close(got, want, dtype, what: str) -> float:
    """Kernel output against its plain version at the stated tolerance;
    returns max |err|. f32: rtol 2e-4 / atol 2e-5. bf16 and f16: both
    sides compute in f32 and round once, so they may differ by one step
    of the type's rounding: rtol 1.5 x its eps (bf16 1.17e-2, f16
    1.46e-3) and atol 1e-4."""
    import torch
    tol = ({"rtol": 2e-4, "atol": 2e-5} if dtype == torch.float32
           else {"rtol": 1.5 * torch.finfo(dtype).eps, "atol": 1e-4})
    require(got.dtype == want.dtype and got.shape == want.shape,
            f"{what}: dtype or shape differs from the plain version")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    require(bool(torch.isfinite(g).all()) and torch.allclose(g, w, **tol),
            f"{what}: differs from the plain version, max |err| {err}")
    return err


# (B, F, d, dtype): dlrm-mlperf (26 sparse fields + the bottom-MLP vector,
# d 128) at its training batch in f32 (the row of the kernels line) and
# bf16; the kernel bench's --full batch; serve_p99's batch; an f16 check
DOT_SHAPES = [(65536, 27, 128, "float32"), (65536, 27, 128, "bfloat16"),
              (2048, 27, 128, "float32"), (512, 27, 128, "float32"),
              (2048, 27, 128, "float16")]


def check_dot_interaction(bench_run: dict, device: str = "cuda") -> dict:
    import torch

    from repro_torch.kernels import dot_interaction, ref

    g = torch.Generator(device=device).manual_seed(4)
    rows, max_err = {}, 0.0
    for b, f, d, dtype in DOT_SHAPES:
        dt = getattr(torch, dtype)
        shape = f"B={b} F={f} d={d} {dtype}"
        x = torch.randn(b, f, d, generator=g, device=device).to(dt)
        err = check_close(dot_interaction(x), ref.dot_interaction(x), dt,
                          f"dot_interaction {shape}")
        max_err = max(max_err, err)
        xi = torch.randint(-3, 4, (b, f, d), generator=g,
                           device=device).to(dt)
        require(torch.equal(dot_interaction(xi), ref.dot_interaction(xi)),
                f"dot_interaction {shape} not exact on integer inputs")
        p = f * (f - 1) // 2
        ops = 2.0 * b * p * d
        bms, by = (bound((x.numel() + b * p) * x.element_size(), ops)
                   if dt == torch.float32 else
                   bound((x.numel() + b * p) * x.element_size(), 0.0, ops))
        i, j = torch.tril_indices(f, f, -1, device=x.device)
        rows[shape] = {
            "ms": time_ms(lambda: dot_interaction(x)),
            "plain_ms": time_ms(lambda: ref.dot_interaction(x), iters=10),
            "library_ms": time_ms(
                lambda: torch.bmm(x, x.transpose(1, 2))[:, i, j]),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        log(f"dot_interaction {shape}: agrees, exact on integer inputs; "
            f"{rows[shape]}")
    xs = torch.randint(-3, 4, (27, 512, 128), generator=g,
                       device=device).float().transpose(0, 1)
    require(torch.equal(dot_interaction(xs), ref.dot_interaction(xs)),
            "dot_interaction differs on a strided input")
    if device == "cuda":                 # the plain version has no cap
        try:
            dot_interaction(torch.zeros(2, 500, 128, device=device))
            raise SmokeFailure("dot_interaction accepted a tile beyond "
                               "shared memory")
        except ValueError:
            pass
    log("dot_interaction edge cases (strided input, tile cap): pass")
    main_shape = next(iter(rows))
    main = rows[main_shape]
    return {"name": "dot_interaction", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dot_interaction.cu",
            "replaces": "src/repro/kernels/dot_interaction.py:45",
            "launches": bench_run["launches"]["dot_interaction"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main_shape, "by_shape": rows}


# (B, H, Sq, Skv, d, dtype, causal, timed): one layer of qwen1.5-32b (40
# heads of 128) at train_4k's sequence, batch 1 (the row of the kernels
# line); the kernel bench's --full shape, causal and not; SASRec's d 50
# with Sq != Skv, f16, and bf16 at d 256 (the CUDA-core route), checked
# only
FLASH_SHAPES = [(1, 40, 4096, 4096, 128, "bfloat16", True, True),
                (2, 8, 2048, 2048, 128, "float32", True, True),
                (2, 8, 2048, 2048, 128, "float32", False, True),
                (4, 2, 200, 328, 50, "float32", True, False),
                (1, 8, 1024, 1024, 128, "float16", True, False),
                (2, 4, 200, 328, 50, "bfloat16", True, False),
                (1, 4, 512, 512, 256, "bfloat16", True, False)]


def attention_ops(b, h, sq, skv, d, causal) -> float:
    """Multiply-adds x 2 of q·kᵀ and P·V over the (query, key) pairs the
    mask keeps (key position <= query position when causal)."""
    pairs = (sum(min(i + 1, skv) for i in range(sq)) if causal
             else sq * skv)
    return 4.0 * b * h * pairs * d


def check_flash_attention(bench_run: dict, device: str = "cuda") -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention, ref
    from repro_torch.kernels.flash_attention import route

    g = torch.Generator(device=device).manual_seed(5)
    rows, max_err = {}, 0.0
    for b, h, sq, skv, d, dtype, causal, timed in FLASH_SHAPES:
        dt = getattr(torch, dtype)
        shape = (f"B={b} H={h} Sq={sq} Skv={skv} d={d} {dtype} "
                 f"{'causal' if causal else 'full'}")
        q, k, v = (torch.randn(b, h, s, d, generator=g, device=device).to(dt)
                   for s in (sq, skv, skv))
        before = flash_routes()
        got = flash_attention(q, k, v, causal=causal)
        ran = [r for r, n in flash_routes().items() if n > before[r]]
        want_route = route(dt, d)
        require(device != "cuda" or ran == [want_route],
                f"flash_attention {shape}: ran route {ran}, not "
                f"{want_route}")
        err = check_close(got, ref.flash_attention(q, k, v, causal=causal),
                          dt, f"flash_attention {shape}")
        max_err = max(max_err, err)
        if not timed:
            log(f"flash_attention {shape}: route {want_route}, agrees, max "
                f"|err| {err}")
            continue
        # f32: every operation at the f32 rate; 16-bit: every product at
        # the tensor rate (q·kᵀ multiplies two inputs, and the kernel runs
        # P·V on the tensor cores too, P split in two 16-bit halves)
        ops = attention_ops(b, h, sq, skv, d, causal)
        bms, by = (bound(4 * q.numel() * q.element_size(), ops)
                   if dt == torch.float32 else
                   bound(4 * q.numel() * q.element_size(), 0.0, ops))
        rows[shape] = {
            "route": want_route,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "plain_ms": time_ms(lambda: ref.flash_attention(
                q, k, v, causal=causal), iters=5, warmup=1),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal)),
            "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        log(f"flash_attention {shape}: agrees; {rows[shape]}")
    # strided [B, S, H, d] views, as a model's layout passes them
    qs, ks, vs = (torch.randn(2, 256, 4, 64, generator=g,
                              device=device).transpose(1, 2)
                  for _ in range(3))
    max_err = max(max_err, check_close(
        flash_attention(qs, ks, vs), ref.flash_attention(qs, ks, vs),
        torch.float32, "flash_attention on strided inputs"))
    log("flash_attention edge cases (d=50, Sq != Skv, f16, bf16 d=256, "
        "strided): pass")
    main_shape = next(iter(rows))
    main = rows[main_shape]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:87",
            "launches": bench_run["launches"]["flash_attention"],
            "max_abs_err": max_err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": main_shape, "by_shape": rows}


# ---------------------------------------------------------------------------
# where a request's device time goes (torch.profiler, fused scorer, B=64)
# ---------------------------------------------------------------------------
def device_times(prof, n: int) -> dict:
    """ms of device time per unit (request, step) by kernel name, from a
    ``torch.profiler`` run over ``n`` units. Only kernels count: the
    ranges of the autograd functions (``_Propagate``, ``_CodebookSum``),
    which the profiler also gives device time, would count their
    kernels twice."""
    from torch.autograd import DeviceType
    per_kernel = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if (t > 0 and e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith(("aten::", "cuda"))):
            per_kernel[e.key[:70]] = t / 1e3 / n
    return per_kernel


def profile_chunk(trainer, n: int) -> dict:
    """One fused chunk of ``n`` training steps under ``torch.profiler``:
    device time per step by kernel, wall time per step, idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.backend.chunk(trainer, n).tolist()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = device_times(prof, n)
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    log(f"profile (training, {n} fused steps): device busy {busy:.3f} ms of "
        f"{wall_ms / n:.3f} ms a step")
    for name, ms in top:
        log(f"  {ms:8.4f} ms  {100 * ms / busy:5.1f}%  {name}")
    return {"steps": n, "device_ms_per_step": busy,
            "wall_ms_per_step": wall_ms / n,
            "idle_share": 1.0 - busy / (wall_ms / n),
            "top_kernels_ms": dict(top)}


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
    per_kernel = device_times(prof, n)                 # ms per request
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
# phase 6: small input, GPU against the port's own CPU (plain) path
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
    from repro_torch.training import TrainConfig, Trainer

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
    # 20 training steps on the GPU and on the port's CPU path: the same
    # numpy batches and init; losses agree to rtol 1e-5 (reductions such
    # as the batch mean add in another order on the two devices)
    cfg = TrainConfig(steps=20, batch_size=2048, lr=5e-3, seed=0,
                      backend="host", sampler="numpy")
    losses = {dev: Trainer(train, sk["cuda"], cfg, device=dev).run(
        log_every=0) for dev in ("cuda", "cpu")}
    require(np.allclose(losses["cuda"], losses["cpu"], rtol=1e-5, atol=0),
            f"GPU and CPU training losses differ: {losses}")
    log(f"gowalla_s: 20 training steps, GPU losses == CPU losses to rtol "
        f"1e-5 (last {losses['cuda'][-1]:.6f} / {losses['cpu'][-1]:.6f})")


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
            run["stream"] = stream_path()
            run["frontdoor"] = frontdoor_path(run)
            run["scale"] = scale_path()
            run["baselines"] = baselines_path(run, workdir)
            emb_run = embedding_path(run)
            bench_run = bench_path()
            floor = timer_floor_ms()
            log(f"kernel timer floor (one-element add): {floor:.5f} ms")
            kernels = [check_codebook_lookup(run), check_fused_topk(run),
                       check_fused_topk_codebook(run, emb_run),
                       check_embedding_bag(run, emb_run),
                       check_dot_interaction(bench_run),
                       check_flash_attention(bench_run)]
            prof = profile_requests(run)
        small_reference()
    except (SmokeFailure, RuntimeError, ValueError, AssertionError,
            subprocess.CalledProcessError) as e:
        log(f"FAIL: {type(e).__name__}: {e}")
        return 1
    print(json.dumps({"stream": run["stream"]}))
    print(json.dumps({"frontdoor": run["frontdoor"]}))
    print(json.dumps({"scale": run["scale"]}))
    print(json.dumps({"baselines": run["baselines"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"timer": {"floor_ms": floor,
                                "spin_cycles": spin_cycles()}}))
    tr = run["training"]
    print(json.dumps({"main_path": {
        "cluster_s": run["cluster_s"], "cluster": run["cluster"],
        "solver_stats": run["stats"], "serve": run["serve"],
        "profile": prof,
        "training": {k: tr[k] for k in (
            "steps", "ms_per_step", "ms_per_step_chunks", "seconds",
            "loss_first", "loss_last", "untrained", "trained",
            "recall_ratio", "launches", "weighted_per_step",
            "profile")}}}))
    print(json.dumps({"embedding_path": {
        "seconds": emb_run["seconds"], "launches": emb_run["launches"],
        "readout_cases": emb_run["readout_cases"],
        "near_tie_ids": emb_run["near_tie_ids"]}}))
    print(json.dumps({"kernel_bench": bench_run}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

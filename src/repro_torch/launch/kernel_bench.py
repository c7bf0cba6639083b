"""Kernel micro-benchmarks of the port: ``python -m repro_torch.launch.kernel_bench``.

Port of ``benchmarks/kernel_bench.py`` (bench ``kernel``), on the port's
kernels and at the reference's shapes, with the same seeded inputs
(numpy, seed 0)::

    python -m repro_torch.launch.kernel_bench [--full] [--device cuda|cpu]
    python -m repro_torch.launch.kernel_bench --json [--repeats N] [--store DIR] [--profile]

* Without ``--json``, ``--out`` or ``--profile``, :func:`run` times the
  four classic ops (the codebook lookup, the embedding bag, DLRM's dot
  interaction and flash attention) at the fast shapes, or the ``--full``
  ones, and prints one ``name,us_per_call,derived`` row each
  (``gb_moved``, ``gflops``), then ``kernel/flash_attention_maxerr``: the
  kernel's output against ``ref.mha``. Nothing is recorded.
* With any of them, the sweep: every registered lookup backend over the
  codebook shapes (:func:`bench_backends`), the fused top-k scorer
  against the dense path (:func:`bench_fused`, with the codebook-expanded
  shape), recorded through ``repro_torch.results.BenchRun`` with the
  reference's config and its headline metrics (:func:`sweep_metrics`);
  ``--json`` prints the payload as one line.

Runs on the CUDA device by default; ``--device cpu`` runs the kernels'
plain versions. On the card a time comes from CUDA events around the
calls, after one warm call; on the CPU from the host clock, and it is a
time of PyTorch's CPU kernels, not of a device.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.rows import Row
from repro_torch.obs import clock
from repro_torch.results import BenchRun, higher, lower

__all__ = ["Row", "run", "bench_backends", "bench_fused", "sweep_metrics",
           "main", "SWEEP_SHAPES", "FUSED_SHAPES", "FUSED_CB_SHAPE"]

# the reference's sweeps (benchmarks/kernel_bench.py:22-45)
SWEEP_SHAPES = [                 # (B, K, d, H)
    (256, 4096, 64, 1),
    (256, 4096, 64, 2),
    (1024, 8192, 64, 2),
    (512, 16384, 128, 2),
]
FUSED_SHAPES = [                 # (B, n_items, d, k)
    (64, 4096, 64, 20),
    (64, 16384, 64, 20),
    (256, 16384, 64, 100),
]
FUSED_CB_SHAPE = (64, 2048, 64, 20, 512, 2)   # (B, N, d, k, K rows, H)


def _time_us(fn, device: torch.device, repeats: int = 1):
    """(last output, microseconds per call) of ``fn`` after one warm
    call: CUDA events on the card, the host clock on the CPU."""
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end) * 1e3 / repeats
    t0 = clock.now()
    for _ in range(repeats):
        out = fn()
    return out, (clock.now() - t0) * 1e6 / repeats


def run(fast: bool = True, device=None):
    """The classic rows at the reference's shapes; returns the rows."""
    from repro_torch.kernels import codebook_lookup, embedding_bag, ops, ref

    dev = resolve_device(device)
    rows = Row()
    rng = np.random.default_rng(0)

    def t(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    # codebook lookup: K=26k (gowalla 1/4 budget), d=64, 2-hot
    k, d, b = (8192, 64, 1024) if fast else (32768, 64, 8192)
    cb = t(rng.standard_normal((k, d)), torch.float32)
    idx = t(rng.integers(0, k, (b, 2)), torch.int32)
    _, us = _time_us(lambda: codebook_lookup(cb, idx), dev)
    bytes_moved = b * (2 * d * 4 + d * 4 + 8)
    rows.add("kernel/codebook_lookup", us, gb_moved=bytes_moved / 1e9,
             intensity_flops_per_byte=(b * d) / bytes_moved)

    # embedding bag: dlrm-ish
    n, nnz, nseg = (20000, 4096, 512) if fast else (200000, 65536, 8192)
    table = t(rng.standard_normal((n, 128)), torch.float32)
    vals = t(rng.integers(0, n, nnz), torch.int32)
    segs = t(np.sort(rng.integers(0, nseg, nnz)), torch.int32)
    _, us = _time_us(lambda: embedding_bag(table, vals, segs, nseg), dev)
    rows.add("kernel/embedding_bag", us,
             gb_moved=(nnz * 128 * 4 + nseg * 128 * 4) / 1e9)

    # dot interaction: DLRM (F=27, d=128)
    bsz = 256 if fast else 2048
    x = t(rng.standard_normal((bsz, 27, 128)), torch.float32)
    _, us = _time_us(lambda: ops.dot_interaction(x, block_b=128), dev)
    rows.add("kernel/dot_interaction", us,
             gflops=2 * bsz * 27 * 27 * 128 / 1e9)

    # flash attention: train-ish tile
    b2, h, s, dh = (1, 2, 512, 64) if fast else (2, 8, 2048, 128)
    q = t(rng.standard_normal((b2, h, s, dh)), torch.float32)
    kk = t(rng.standard_normal((b2, h, s, dh)), torch.float32)
    v = t(rng.standard_normal((b2, h, s, dh)), torch.float32)
    out, us = _time_us(lambda: ops.flash_attention(q, kk, v, causal=True),
                       dev)
    rows.add("kernel/flash_attention", us,
             gflops=2 * 2 * b2 * h * s * s * dh / 2 / 1e9)
    # correctness cross-check rides along
    err = float((out - ref.mha(q, kk, v, causal=True)).abs().max())
    rows.add("kernel/flash_attention_maxerr", 0.0, max_abs_err=err)
    return rows.emit()


def bench_backends(shapes=None, repeats: int = 3, device=None):
    """Per-backend codebook-lookup timings -> list of JSON-able records."""
    from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                       available_backends)
    dev = resolve_device(device)
    shapes = shapes or SWEEP_SHAPES
    rng = np.random.default_rng(0)
    records = []
    for (b, k, d, h) in shapes:
        cb = torch.as_tensor(rng.standard_normal((k, d)), dtype=torch.float32,
                             device=dev)
        sketch = torch.as_tensor(rng.integers(0, k, (4 * b, h)),
                                 dtype=torch.int32, device=dev)
        ids = torch.as_tensor(rng.integers(0, 4 * b, b), dtype=torch.int32,
                              device=dev)
        bytes_moved = b * (h * d * 4 + d * 4 + 4 * h + 4)
        for name in available_backends():
            spec = EmbeddingSpec(n_rows=4 * b, dim=d, k_rows=k, n_hot=h)
            eng = EmbeddingEngine(spec, backend=name)
            try:
                _, us = _time_us(lambda: eng.codebook_lookup(cb, sketch, ids),
                                 dev, repeats)
            except (NotImplementedError, ValueError) as exc:
                # a declared capability or shape gap is a row of its own
                records.append({"backend": name, "B": b, "K": k, "d": d,
                                "H": h, "error": str(exc)[:200],
                                "error_type": type(exc).__name__})
                continue
            records.append({
                "backend": name, "B": b, "K": k, "d": d, "H": h,
                "us_per_call": round(us, 2),
                "gb_moved": bytes_moved / 1e9,
                "intensity_flops_per_byte": (b * h * d) / bytes_moved,
            })
    return records


def bench_fused(shapes=None, cb_shape=FUSED_CB_SHAPE, repeats: int = 3,
                device=None):
    """Fused-vs-dense top-k over (B, n_items, d, k).

    Variants per shape:
      dense       the port's dense serving path, ``topk(u @ V.T, k)``;
                  its traffic includes writing and re-reading the [B, N]
                  score matrix
      fused       the fused_topk kernel (scores never leave the chip)
      fused_int8  the same over int8 item rows, dequantized in the kernel
    plus one codebook-expansion shape (dense_cb, fused_cb, fused_cb_int8)
    where the [N, d] item matrix never exists either. A variant the
    kernel refuses (k above its cap) is a record with its error.
    """
    from repro_torch import embedding as E
    from repro_torch.embedding.engine import topk
    from repro_torch.kernels import ref
    dev = resolve_device(device)
    shapes = shapes or FUSED_SHAPES
    rng = np.random.default_rng(0)
    records = []

    def t(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def record(variant, b, n, d, k, fn, bytes_moved, dense_us=None,
               **extra):
        head = {"variant": variant, "B": b, "N": n, "d": d, "K": k}
        try:
            _, us = _time_us(fn, dev, repeats)
        except ValueError as exc:
            records.append({**head, **extra, "error": str(exc)[:200],
                            "error_type": type(exc).__name__})
            return None
        dense_us = us if dense_us is None else dense_us
        records.append({**head, **extra, "us_per_call": round(us, 2),
                        "bytes_moved": bytes_moved,
                        "achieved_gbps": round(bytes_moved / (us / 1e6) / 1e9,
                                               4),
                        "speedup_vs_dense": round(dense_us / us, 3)})
        return us

    for (b, n, d, k) in shapes:
        u = t(rng.standard_normal((b, d)))
        v_np = rng.standard_normal((n, d)).astype(np.float32)
        v = t(v_np)
        q, scale = E.quantize_int8_rows(v_np)
        q, scale = t(q, torch.int8), t(scale)
        base = b * d * 4 + b * k * 8              # users in, (vals, ids) out
        dense_us = record("dense", b, n, d, k, lambda: topk(u @ v.T, k),
                          base + n * d * 4 + 2 * b * n * 4)
        record("fused", b, n, d, k, lambda: E.fused_topk(u, v, k),
               base + n * d * 4, dense_us)
        record("fused_int8", b, n, d, k,
               lambda: E.fused_topk(u, q, k, scale=scale),
               base + n * d + n * 4, dense_us)

    if cb_shape is not None:
        b, n, d, k, kr, h = cb_shape
        u = t(rng.standard_normal((b, d)))
        cb_np = rng.standard_normal((kr, d)).astype(np.float32)
        cb = t(cb_np)
        sk = t(rng.integers(0, kr, (n, h)), torch.int32)
        q, scale = E.quantize_int8_rows(cb_np)
        q, scale = t(q, torch.int8), t(scale)
        base = b * d * 4 + b * k * 8 + n * h * 4          # + sketch reads
        dense_us = record(
            "dense_cb", b, n, d, k,
            lambda: topk(u @ ref.expand_items(cb, sketch=sk).T, k),
            base + n * h * d * 4 + 2 * n * d * 4 + 2 * b * n * 4, H=h)
        record("fused_cb", b, n, d, k,
               lambda: E.fused_topk(u, cb, k, sketch=sk),
               base + n * h * d * 4, dense_us, H=h)
        record("fused_cb_int8", b, n, d, k,
               lambda: E.fused_topk(u, q, k, sketch=sk, scale=scale),
               base + n * h * (d + 4), dense_us, H=h)
    return records


def sweep_metrics(lookup, fused) -> dict:
    """Declared-direction headline metrics of the sweep record: the
    reference's, on rows of either package (the port's rows name their
    speedup ``speedup_vs_dense``, the reference's ``speedup_vs_dense_xla``;
    the metric takes the rows' name)."""
    frecs = [r for r in fused
             if isinstance(r, dict) and "us_per_call" in r]
    out = {"fused_records": higher(len(frecs)),
           "lookup_errors": lower(len([r for r in lookup
                                       if "error" in r]))}
    for variant, label in (("fused", "best_fused_gbps"),
                           ("fused_int8", "best_int8_gbps")):
        vals = [r["achieved_gbps"] for r in frecs
                if r.get("variant") == variant
                and isinstance(r.get("achieved_gbps"), (int, float))]
        if vals:
            out[label] = higher(max(vals))
    for key in ("speedup_vs_dense_xla", "speedup_vs_dense"):
        sp = [r[key] for r in frecs
              if r.get("variant", "").startswith("fused")
              and isinstance(r.get(key), (int, float))]
        if sp:
            out[f"best_{key}"] = higher(max(sp))
    us = [r["us_per_call"] for r in lookup if "us_per_call" in r]
    if us:
        out["best_lookup_us"] = lower(min(us))
    return out


def main(argv=None):
    bench = BenchRun("kernel", description=__doc__)
    bench.add_argument("--full", action="store_true",
                       help="full (slow) shapes for the classic kernel "
                            "bench")
    bench.add_argument("--repeats", type=int, default=3,
                       help="calls timed per sweep row (default 3, the "
                            "reference's; a row of a few calls of "
                            "~0.1 ms is mostly launch jitter)")
    args = bench.parse(argv)
    dev = bench.device
    if not (args.json or args.out or args.profile):
        run(fast=not args.full, device=dev)
        return 0
    config = {"mode": "sweep", "sweep_shapes": SWEEP_SHAPES,
              "fused_shapes": FUSED_SHAPES, "cb_shape": FUSED_CB_SHAPE,
              "repeats": args.repeats}
    hit = bench.cached(config)
    if hit is not None:
        bench.replay(hit)
        return 0
    with bench.profile("codebook_sweep"):
        lookup = bench_backends(SWEEP_SHAPES, repeats=args.repeats,
                                device=dev)
    with bench.profile("fused_sweep"):
        fused = bench_fused(FUSED_SHAPES, FUSED_CB_SHAPE,
                            repeats=args.repeats, device=dev)
    metrics = sweep_metrics(lookup, fused)
    record = {"bench": "kernel", "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "config": config, "metrics": metrics,
              "codebook_lookup": lookup, "fused": fused}
    bench.emit(config, metrics, record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

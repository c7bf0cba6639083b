#!/usr/bin/env python3
"""Holds the port's flash_attention kernel (``flash_attention.cu``) and
another build of its source against the plain version on one NVIDIA
GPU, and times both builds and SDPA in one call (a check made when the
kernel is rewritten).

    mkdir -p build/parent
    for f in flash_attention.cu f32_convert.cuh; do
      git show <commit>:src/repro_torch/kernels/csrc/$f > build/parent/$f
    done
    python3 tools/flash_attention_parity.py build/parent

The other source must have the same C interface
(``flash_attention_launch``, ``flash_attention_tc_launch``); each shape
runs on the route ``flash_attention.route`` gives it in both builds. The
cases: ``chip_smoke.FLASH_SHAPES`` (the qwen1.5-32b layer, the kernel
bench's f32 d 128, the paths' SASRec train / serve and BERT4Rec serve
shapes, and the checked-only edge shapes) and ``MORE_SHAPES`` (blocks
that walk several sequences, causal and full; Sq != Skv at short
sequences; d 32 and 50 at S 49, 50 and 200). Each result must agree
with ``ref.flash_attention`` within rtol 2e-4 / atol 2e-5 (f32) or 2e-2
(16-bit), as in the smoke. The timed shapes are timed with
``chip_smoke.time_ms`` (L2 flushed, a device spin before the start
event) in turns: other build, this build, this build, other build, then
``F.scaled_dot_product_attention`` (the library call). Prints one JSON
line; exits non-zero unless every case agrees.
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

# (B, H, Sq, Skv, d, dtype, causal), checked only
MORE_SHAPES = [(4099, 1, 49, 49, 50, "float32", True),
               (4099, 1, 49, 49, 50, "float32", False),
               (4099, 1, 50, 50, 32, "float32", True),
               (300, 3, 20, 49, 50, "float32", True),
               (300, 3, 49, 20, 50, "float32", True),
               (300, 3, 49, 20, 32, "float32", False),
               (64, 2, 200, 200, 50, "float32", True),
               (64, 2, 200, 200, 32, "float32", True),
               (3, 2, 1, 1, 50, "float32", True),
               (3, 2, 33, 65, 3, "float32", True),
               (2, 2, 130, 70, 200, "float32", False)]


def bind(path: str):
    """flash(q, k, v, causal) of the library at ``path``, on the route
    the port's wrapper would take, allocating its output like it."""
    import torch

    from repro_torch.kernels import platform, ref
    from repro_torch.kernels.flash_attention import route

    args = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fns = {"cc": parity_build.entry(path, "flash_attention_launch", args),
           "tc": parity_build.entry(path, "flash_attention_tc_launch", args)}

    def flash(q, k, v, causal):
        b, h, sq, d = q.shape
        out = torch.empty_like(q)
        status = fns[route(q.dtype, d)](
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            sq, k.shape[2], d, int(causal), ref.attention_scale(d),
            platform.DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
        if status:
            raise RuntimeError(f"{path}: launch {status}")
        return out

    return flash


def main(other_dir: str) -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import flash_attention, platform, ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    started = parity_build.start(
        os.path.join(other_dir, "flash_attention.cu"), "flash_attention_other")
    platform.build(["flash_attention"])
    old = bind(parity_build.finish(started)[0])

    g = torch.Generator(device="cuda").manual_seed(5)
    shapes = (list(chip_smoke.FLASH_SHAPES)
              + [s + (False,) for s in MORE_SHAPES])
    results, bad, times = {}, [], {}
    t = chip_smoke.time_ms
    for b, h, sq, skv, d, dtype, causal, timed in shapes:
        dt = getattr(torch, dtype)
        name = (f"B={b} H={h} Sq={sq} Skv={skv} d={d} {dtype} "
                f"{'causal' if causal else 'full'}")
        q, k, v = (torch.randn(b, h, s, d, generator=g, device="cuda").to(dt)
                   for s in (sq, skv, skv))
        want = ref.flash_attention(q, k, v, causal=causal).float()
        tol = ((2e-4, 2e-5) if dt == torch.float32 else (2e-2, 2e-2))
        row = {}
        for which, fn in (("new", lambda: flash_attention(q, k, v,
                                                          causal=causal)),
                          ("old", lambda: old(q, k, v, causal))):
            got = fn().float()
            err = (got - want).abs()
            row[f"{which}_max_abs_err"] = float(err.max())
            if not bool((err <= tol[1] + tol[0] * want.abs()).all()):
                bad.append(f"{which} {name}")
        del want
        results[name] = row
        if timed:
            row["old_ms"] = [t(lambda: old(q, k, v, causal))]
            row["new_ms"] = [t(lambda: flash_attention(q, k, v,
                                                       causal=causal))
                             for _ in range(2)]
            row["old_ms"].append(t(lambda: old(q, k, v, causal)))
            row["library_ms"] = t(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            row["bound_ms"], row["bound_by"] = kcost.bound(
                kcost.flash_attention(q, k, v, causal=causal))
            times[name] = row
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps({"flash_parity": {
        "other": other_dir, "cases": len(results),
        "disagree": bad[:20], "results": results, "times": times,
        "timer_floor_ms": chip_smoke.timer_floor_ms(),
        "gpu": chip_smoke.gpu_line()}}))
    return 0 if not bad else 1


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1].startswith("-"):
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))

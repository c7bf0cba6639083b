#!/usr/bin/env python3
"""Holds the port's dot-interaction kernel bitwise against another build
of its source on one NVIDIA GPU (a check made once, when the kernel is
rewritten).

    git show <commit>:src/repro_torch/kernels/csrc/dot_interaction.cu \\
        > build/parent/dot_interaction.cu
    python3 tools/dot_interaction_parity.py build/parent/dot_interaction.cu

The other source must have the same C interface (``dot_interaction_launch``,
and ``f32_convert.cuh`` beside it or in ``csrc/``). Both builds compute each
output as one fmaf chain over k in order with one rounding at the store, so
they must agree bit for bit on any input. The cases are ``chip_smoke.py``'s
``DOT_SHAPES`` and the ``cuda`` tests' shapes (every F mod 4, one tile per
lane and lanes looping over tiles, scalar tails of d, a batch that is not a
multiple of a block's examples, an input not 16-byte aligned), each in f32,
bf16 and f16, on seeded normal inputs. The ``DOT_SHAPES`` rows are also
timed in both builds. Prints one JSON line with the counts of bitwise-equal
results and the times; exits non-zero unless every case is equal.
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

DTYPES = ("float32", "bfloat16", "float16")
FS = (2, 3, 4, 5, 8, 27, 28, 29, 33, 41, 100)
DS = (1, 3, 50, 128, 129, 256)


def cases():
    """(B, F, d, unaligned) of the check, dtype aside."""
    out = [(b, f, d, False) for b, f, d, _ in chip_smoke.DOT_SHAPES]
    out += [(1000, 27, 128, False), (37, 41, 16, False), (9, 2, 50, False),
            (300, 100, 256, False)]
    out += [(37, f, d, False) for f in FS for d in DS]
    out += [(6, 5, 3, True), (9, 27, 128, True), (5, 33, 64, True)]
    return list(dict.fromkeys(out))


def inputs(b, f, d, dtype, unaligned, g):
    """Seeded normal x [B, F, d]; with ``unaligned`` a contiguous view
    whose data pointer is not 16-byte aligned."""
    import torch
    dt = getattr(torch, dtype)
    n = b * f * d
    flat = torch.randn(n + 1, generator=g, device="cuda").to(dt)
    return flat[1:].view(b, f, d) if unaligned else flat[:n].view(b, f, d)


def main(src: str) -> int:
    import torch

    from repro_torch.kernels import dot_interaction, platform

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    other = parity_build.entry(
        parity_build.build(src, "dot_interaction_other"),
        "dot_interaction_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

    def theirs(x):
        y = torch.empty(x.shape[0], x.shape[1] * (x.shape[1] - 1) // 2,
                        dtype=x.dtype, device=x.device)
        status = other(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                       x.shape[2], platform.DTYPES[x.dtype],
                       torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"the other build's launch failed: {status}")
        return y

    g = torch.Generator(device="cuda").manual_seed(16)
    counts = {dt: {"cases": 0, "bitwise": 0} for dt in DTYPES}
    unequal = []
    for b, f, d, unaligned in cases():
        for dt in DTYPES:
            x = inputs(b, f, d, dt, unaligned, g)
            same = torch.equal(dot_interaction(x), theirs(x))
            counts[dt]["cases"] += 1
            counts[dt]["bitwise"] += bool(same)
            if not same:
                unequal.append(f"B={b} F={f} d={d} {dt}"
                               + (" unaligned" if unaligned else ""))
    times = {}
    for b, f, d, dt in chip_smoke.DOT_SHAPES:
        x = inputs(b, f, d, dt, False, g)
        times[f"B={b} F={f} d={d} {dt}"] = {
            "ms": chip_smoke.time_ms(lambda: dot_interaction(x)),
            "other_ms": chip_smoke.time_ms(lambda: theirs(x))}
    print(json.dumps({"dot_parity": {
        "source": src, "counts": counts, "unequal": unequal[:20],
        "times": times, "gpu": chip_smoke.gpu_line()}}))
    return 0 if not unequal else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))

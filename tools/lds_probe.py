#!/usr/bin/env python3
"""Cycles per warp-wide 16-byte shared-memory load (``ld.shared.v4``) on
one NVIDIA GPU, for the address patterns of ``dot_interaction.cu``'s inner
loop (a check of its bank layout).

    python3 tools/lds_probe.py [F] [d]          # default F 27, d 128

At (F, d) the kernel stages an example's rows at a stride of d rounded up
to 4, plus 4 floats; lane l works on tile l of the G(G+1)/2 tiles of the
row-group triangle (G = ceil(F/4)) and, per 4 k, loads rows ti + aG and
tj + aG (a = 0..3, rows past F read row F-1); lanes past the tiles stay
idle. One block of 32 warps on one SM issues each pattern's load 3,200
times per warp; the block's clock64 span over all its loads is the cost of
one load, in cycles. Patterns: the kernel's 8 loads at its stride, the
same rows at a stride of d (rows in one bank group, for contrast), one
address for every lane (broadcast), and 32 distinct 16-byte chunks (512
bytes, four 128-byte wavefronts). Prints one JSON line; exits non-zero
without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = r"""
#include <cuda_runtime.h>
extern "C" __global__ void probe(const int* __restrict__ offs, int words,
                                 int iters, unsigned* sink,
                                 long long* cycles) {
  extern __shared__ __align__(16) float smem[];
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = i;
  __syncthreads();
  const int off = offs[threadIdx.x & 31];
  const unsigned base =
      static_cast<unsigned>(__cvta_generic_to_shared(smem)) + 4u * off;
  unsigned acc = 0;
  __syncthreads();
  const long long t0 = clock64();
  if (off >= 0) {
#pragma unroll 1
    for (int i = 0; i < iters; ++i) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        unsigned a, b, c, d;
        asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];"
                     : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                     : "r"(base + 16 * k));
        acc ^= a;
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) *cycles = t1 - t0;
  sink[threadIdx.x] = acc;
}

extern "C" int run_probe(const int* offs, int words, int iters,
                         unsigned* sink, long long* cycles, int threads) {
  const int bytes = words * 4;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  probe<<<1, threads, bytes>>>(offs, words, iters, sink, cycles);
  cudaDeviceSynchronize();
  return static_cast<int>(cudaGetLastError());
}
"""


def tiles(nf: int):
    """(ti, tj) of each lane's tile, as the kernel walks them."""
    g = (nf + 3) // 4
    out = []
    for t in range(min(32, g * (g + 1) // 2)):
        ti, tj = 0, t
        while tj > ti:
            tj -= ti + 1
            ti += 1
        out.append((ti, tj))
    return g, out


def patterns(nf: int, dim: int) -> dict:
    """{name: 32 lane offsets in floats, -1 for an idle lane}."""
    g, lanes = tiles(nf)
    padded = (dim + 3) // 4 * 4 + 4
    out = {}
    for stride, tag in ((padded, f"stride {padded}"), (dim, f"stride {dim}")):
        for side, pick in (("i", 0), ("j", 1)):
            for a in range(4):
                offs = [min(t[pick] + g * a, nf - 1) * stride for t in lanes]
                out[f"{side}-rows a={a}, {tag}"] = offs + [-1] * (32 - len(offs))
    out["broadcast (one address)"] = [0] * 32
    out["32 distinct chunks"] = [4 * lane for lane in range(32)]
    return out


def main(nf: int = 27, dim: int = 128) -> int:
    import torch

    from repro_torch.kernels import platform

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    work = os.path.join(ROOT, "build", "probe")
    os.makedirs(work, exist_ok=True)
    src, lib = os.path.join(work, "lds_probe.cu"), os.path.join(work, "liblds_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([platform.nvcc_path(), *platform.ARCH_FLAGS, "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib, src],
                   check=True, capture_output=True, timeout=600)
    fn = ctypes.CDLL(lib).run_probe
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    pats = patterns(nf, dim)
    words = max(max(o) for o in pats.values()) + 4 * 32 + 4
    iters, threads = 100, 1024
    sink = torch.empty(threads, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    result = {}
    for name, offs in pats.items():
        o = torch.tensor(offs, dtype=torch.int32, device="cuda")
        for _ in range(2):                      # the first call warms up
            status = fn(o.data_ptr(), words, iters, sink.data_ptr(),
                        cycles.data_ptr(), threads)
            if status != 0:
                raise RuntimeError(f"probe launch failed: {status}")
        loads = iters * 32 * threads // 32
        result[name] = {"cycles_per_load": cycles.item() / loads,
                        "lanes": sum(x >= 0 for x in offs),
                        "distinct": len({x for x in offs if x >= 0})}
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"lds_probe": {"F": nf, "d": dim, "gpu": gpu,
                                    "patterns": result}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:3])))

#!/usr/bin/env python3
"""Holds the port's fused top-k kernel bitwise against another build of
its source on one NVIDIA GPU (a check made once, when the kernel is
rewritten).

    git show <commit>:src/repro_torch/kernels/csrc/fused_topk.cu \\
        > build/parent/fused_topk.cu
    python3 tools/fused_topk_parity.py build/parent/fused_topk.cu

The other source must have the same C interface (``fused_topk_launch``,
``fused_topk_codebook_launch``); it is called with 1,024-item chunks. The
inputs are ``chip_smoke.py``'s: the amazonbook main path's propagated
embeddings (dense top-k at B 1, 8, 64, 512 with the item mask, k 20, both
builds also timed) and the embedding phase's 48 codebook-readout cases.
Prints one JSON line with the counts of bitwise-equal results (values and
ids); exits non-zero unless every case is equal.
"""
from __future__ import annotations

import ctypes
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402  (puts src/ on the path)
import parity_build  # noqa: E402


def bind(path: str) -> dict:
    """The two C entry points of the library at ``path``."""
    return {"dense": parity_build.entry(
                path, "fused_topk_launch",
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_void_p] * 5),
            "codebook": parity_build.entry(
                path, "fused_topk_codebook_launch",
                [ctypes.c_void_p] * 4 + [ctypes.c_int]
                + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                + [ctypes.c_void_p] * 5)}


def run(launch, lead, u, k, n, scale, mask, exclude, chunk=1024):
    """One call of the other build, with its outputs and chunk scratch."""
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
    args = [u.contiguous(), *lead, mask, ex_ptr, ex_ids]
    status = launch(
        *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
        rows, n, u.shape[1], k, chunk, int(scale is not None),
        part_v.data_ptr(), part_i.data_ptr(), out_v.data_ptr(),
        out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if status != 0:
        raise RuntimeError(f"the other build's launch failed: {status}")
    return out_v, out_i


def main(src: str) -> int:
    import torch

    from repro_torch.embedding import dequantize_params
    from repro_torch.kernels import fused_topk
    from repro_torch.models import lightgcn as L

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    other = bind(parity_build.build(src, "fused_topk_other"))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as wd:
        main_run = chip_smoke.main_path(wd)
    dev = torch.device("cuda")
    loaded = main_run["loaded"]
    params = {kk: torch.as_tensor(vv, device=dev)
              for kk, vv in loaded.params.items()}
    statics = loaded.statics(dev)
    u_all, v_all = L.all_embeddings(dequantize_params(params), statics,
                                    loaded.mcfg())
    mask = statics.get("item_mask")
    n, k = v_all.shape[0], 20
    dense = {}
    for b in (1, 8, 64, 512):
        u = u_all[:b].contiguous()

        def theirs():
            return run(other["dense"], (v_all.contiguous(), None), u, k, n,
                       None, mask, None)

        a, o = fused_topk(u, v_all, k, mask=mask), theirs()
        dense[b] = {"bitwise": bool(torch.equal(a[0], o[0])
                                    and torch.equal(a[1], o[1])),
                    "ms": chip_smoke.time_ms(
                        lambda: fused_topk(u, v_all, k, mask=mask)),
                    "other_ms": chip_smoke.time_ms(theirs)}
    n_cases = n_equal = 0
    emb = chip_smoke.embedding_inputs(main_run, "cuda")
    for side in ("items", "users"):
        for b in (1, 8, 64, 512):
            for u, kw in chip_smoke.readout_cases(emb, side, b, "cuda"):
                items, sk = kw.pop("items"), kw.pop("sketch")
                scale = kw.get("scale")
                a = fused_topk(u, items, k, sketch=sk, **kw)
                o = run(other["codebook"],
                        (items, scale, sk, int(sk.shape[1])), u, k,
                        int(sk.shape[0]), scale, kw.get("mask"),
                        kw.get("exclude"))
                n_cases += 1
                n_equal += bool(torch.equal(a[0], o[0])
                                and torch.equal(a[1], o[1]))
    result = {"source": src, "dense": dense, "codebook_cases": n_cases,
              "codebook_bitwise": n_equal}
    print(json.dumps({"topk_parity": result}))
    ok = n_equal == n_cases and all(r["bitwise"] for r in dense.values())
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))

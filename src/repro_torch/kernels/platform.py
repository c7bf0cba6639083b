"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Nothing is compiled or loaded when this module is imported:
the CPU tests import every module, and the CPU has no ``nvcc``.

The library name carries a digest of its source and of the shared
headers (``csrc/*.cuh``), so an edited kernel is never served from a
stale build. Builds go to ``build/kernels`` at the
repository root (listed in ``.gitignore``). :func:`build` starts one
``nvcc`` per source, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from repro_torch.obs import clock

__all__ = ["KERNELS", "CSRC", "BUILD_DIR", "DTYPES", "build", "load",
           "nvcc_path", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("codebook_lookup", "dot_interaction", "embedding_bag",
           "flash_attention", "fused_topk")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
# the dtype code of the launches that take f32, bf16 or f16
# (``csrc/f32_convert.cuh``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME``,
    ``CUDA_PATH``, ``nvcc`` on PATH, or the toolkit's default prefix)."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc and os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> list:
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
            str(CSRC / f"{name}.cu")]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that have no current
    build, one ``nvcc`` process per source, all started together.
    Returns {name: {"seconds": wall time, "log": compiler output}}; a
    kernel already built reports 0 seconds. Raises if any build fails.
    """
    names = tuple(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = clock.now()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": clock.now() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(status: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code
    (its ``cudaGetLastError()`` right after the launch)."""
    if status != 0:
        fn = load(name).kernel_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{status} ({fn(status).decode()})")

"""Build and bind helpers shared by the ``tools/*_parity.py`` checks: each
builds another copy of a kernel source with the port's nvcc flags and
binds its C entry points with ctypes, beside the port's own build."""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(ROOT, "build", "parity")
sys.path.insert(0, os.path.join(ROOT, "src"))


def start(src: str, name: str) -> tuple:
    """Start one nvcc on ``src`` (the port's flags, its ``csrc/`` on the
    include path) building ``build/parity/lib<name>.so``; returns
    (process, library path)."""
    from repro_torch.kernels import platform
    os.makedirs(OUT_DIR, exist_ok=True)
    out = os.path.join(OUT_DIR, f"lib{name}.so")
    proc = subprocess.Popen(
        [platform.nvcc_path(), *platform.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-I", str(platform.CSRC),
         "-o", out, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def finish(*started) -> list:
    """Wait for builds from :func:`start`; raises if one failed. Returns
    their library paths in order."""
    paths = []
    for proc, out in started:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {out}:\n{log}")
        paths.append(out)
    return paths


def build(src: str, name: str) -> str:
    """Build one source (see :func:`start`) and return its library."""
    return finish(start(src, name))[0]


def entry(path: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of the library at ``path``, returning
    an int status."""
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn

"""Bundle I/O (the part of ``repro.training.checkpoint`` that artifacts
use): ``{arrays.npz, manifest.json}`` published atomically.

The layout is the reference's, byte for byte in the arrays: nested dicts
flatten to "a/b/c" keys in sorted key order (as ``jax.tree_util`` orders
dict keys), ``None`` leaves are dropped, and ``np.savez`` stores them in
that order. Bundles therefore cross between the packages.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Tuple

import numpy as np

__all__ = ["write_bundle", "read_bundle"]

_MANIFEST = "manifest.json"


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"a/b": array} for a dict-of-dicts tree (sorted keys, None
    dropped)."""
    out = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_flatten_with_paths(tree[key], f"{prefix}{key}/"))
    elif tree is not None:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten_paths(arrays: dict) -> dict:
    """Rebuild nested dicts from 'a/b/c' flattened key paths."""
    tree: dict = {}
    for key, arr in arrays.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def write_bundle(parent: str, name: str, tree, manifest: dict) -> str:
    """Atomically publish `<parent>/<name>` = {arrays.npz, manifest.json}.

    Writes to `<parent>/tmp.<name>` then `os.replace`; an existing bundle
    is moved aside whole before the new one is published, and removed
    after."""
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"tmp.{name}")
    old = os.path.join(parent, f"tmp.{name}.old")
    final = os.path.join(parent, name)
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    arrays = _flatten_with_paths(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = dict(manifest)
    manifest["n_arrays"] = len(arrays)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        os.replace(final, old)
    os.replace(tmp, final)
    shutil.rmtree(old, ignore_errors=True)
    return final


def read_bundle(path: str) -> Tuple[dict, dict]:
    """Load a bundle written by `write_bundle`; returns (tree, manifest).

    Raises FileNotFoundError for a missing/incomplete bundle and
    ValueError for a corrupt manifest; retries briefly to ride over a
    republish in progress."""
    manifest_path = os.path.join(path, _MANIFEST)
    for _ in range(3):
        if os.path.isfile(manifest_path):
            break
        time.sleep(0.025)
    else:
        raise FileNotFoundError(
            f"no bundle manifest at {manifest_path!r} (missing or "
            f"incomplete write)")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"corrupt bundle manifest {manifest_path!r}: {e}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        flat = {k: data[k] for k in data.files}
    return _unflatten_paths(flat), manifest

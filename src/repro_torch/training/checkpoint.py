"""Atomic, resumable checkpoints and the bundle I/O under them (port of
``repro.training.checkpoint``).

A bundle is ``{arrays.npz, manifest.json}``, written to ``tmp.<name>``
and published with ``os.replace``, so a crash mid-write never corrupts
the latest one. Checkpoints (``step_<step>`` bundles: params, optimizer
state, and the sampler's ``{"seed", "step"}`` in the manifest) and
serving artifacts are both bundles. The layout is the reference's, byte
for byte in the arrays: nested dicts and lists flatten to "a/b/0/c" keys
in sorted key order (as ``jax.tree_util`` orders dict keys), ``None``
leaves are dropped, tensors are written as host numpy. Checkpoints and
artifacts therefore cross between the packages: a reference
``CheckpointManager``'s checkpoint restores into a port ``Trainer``, and
the reverse.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "CheckpointManager", "write_bundle", "read_bundle"]

_MANIFEST = "manifest.json"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree, prefix: str = "") -> dict:
    """{"a/b": array} for a tree of dicts and lists (sorted keys, list
    positions as keys, None dropped; tensors copied to host numpy)."""
    out = {}
    if isinstance(tree, dict):
        for key in sorted(tree):
            out.update(_flatten_with_paths(tree[key], f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, leaf in enumerate(tree):
            out.update(_flatten_with_paths(leaf, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = _host(tree)
    return out


def _restore_like(like, flat: dict, prefix: str = ""):
    """``like``'s structure (dicts and lists of tensors) with each tensor
    replaced by the array stored under its path, shape-checked, as a
    tensor of the leaf's dtype on its device."""
    if isinstance(like, dict):
        return {k: _restore_like(v, flat, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore_like(v, flat, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"bundle missing array {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: shape {arr.shape} != {tuple(like.shape)}")
    return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)


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


def read_bundle(path: str, like: Any = None) -> Tuple[Any, dict]:
    """Load a bundle written by `write_bundle`; returns (tree, manifest).

    With ``like``, arrays are restored into its structure with shape
    checks, onto its leaves' devices (checkpoint resume); without it,
    nested dicts are rebuilt from the key paths (artifact loading).
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
    if like is not None:
        return _restore_like(like, flat), manifest
    return _unflatten_paths(flat), manifest


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomically write {arrays, manifest} for `step`. Returns final path."""
    return write_bundle(directory, f"step_{step:010d}", tree,
                        {"step": int(step), "extra": extra or {}})


def _steps(directory: str) -> list:
    """The steps with a complete (manifest-bearing) checkpoint, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_")
        and os.path.exists(os.path.join(directory, n, _MANIFEST)))


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a complete (manifest-bearing) checkpoint."""
    steps = _steps(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, step: int,
                       like: Any) -> Tuple[Any, dict]:
    """Restore step ``step`` into the structure of ``like`` (tensors onto
    the devices of ``like``'s tensors); returns (tree, extra)."""
    path = os.path.join(directory, f"step_{step:010d}")
    tree, manifest = read_bundle(path, like=like)
    return tree, manifest["extra"]


class CheckpointManager:
    """Retention + resume orchestration for a training run."""

    def __init__(self, directory: str, keep: int = 3, every: int = 50):
        self.directory = directory
        self.keep = keep
        self.every = every

    def due(self, step: int, prev_step: Optional[int] = None) -> bool:
        """True when a save is owed at `step`. With `prev_step`, owed
        when ANY multiple of `every` lies in (prev_step, step] (chunked
        trainers advance several steps per host visit)."""
        if self.every <= 0:
            return False
        if prev_step is None:
            return step % self.every == 0
        return (step // self.every) > (prev_step // self.every)

    def maybe_save(self, step: int, tree, extra=None, force=False,
                   prev_step: Optional[int] = None):
        if not force and not self.due(step, prev_step):
            return None
        path = save_checkpoint(self.directory, step, tree, extra)
        self._gc()
        return path

    def _gc(self):
        for s in _steps(self.directory)[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)

    def restore_latest(self, like):
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = restore_checkpoint(self.directory, step, like)
        return step, tree, extra

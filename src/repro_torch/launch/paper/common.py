"""Shared helpers of the paper's experiments: datasets, train + eval,
sketches, cluster metrics, CSV rows and timing (a copy of
``benchmarks/common.py`` on the port).

Record emission lives in ``repro_torch.results`` (the BenchRun API):
this module carries the measurement helpers the table and figure
modules share (``Row`` is ``repro_torch.launch.rows.Row``).

Every function that builds or trains takes ``device`` ("cuda" by
default; the CPU only when asked for). Every clock read goes through
:func:`now`, which first waits for the device: the reference's
``time.time()`` brackets JAX calls that return numpy arrays, so they
are synchronous, and a CUDA launch is not.
"""
from __future__ import annotations

import argparse
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ClusterEngine, build_sketch
from repro_torch.core import metrics as M
from repro_torch.data import paperlike_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.rows import Row
from repro_torch.obs import clock
from repro_torch.training import TrainConfig, Trainer

__all__ = ["get_dataset", "train_eval", "sketch_for", "cluster_metrics",
           "Row", "timed", "now", "sync", "main"]


@functools.lru_cache(maxsize=8)
def get_dataset(name: str, seed: int = 0):
    return paperlike_dataset(name, seed=seed)


def sync() -> None:
    """Wait for every CUDA launch of this process (a no-op before CUDA
    is initialised, so on a CPU run)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def now() -> float:
    """``obs.clock.now()`` after the device has finished its work."""
    sync()
    return clock.now()


def sketch_for(method: str, graph, ratio: float = 0.25, d: int = 64,
               seed: int = 0, device="cuda"):
    """None for 'full', else a Sketch from the registry / baco."""
    if method == "full":
        return None
    if method == "baco":
        return ClusterEngine(device=device).build(graph, d=d, ratio=ratio)
    if method == "baco_no_scu":
        return ClusterEngine(device=device).build(graph, d=d, ratio=ratio,
                                                  scu=False)
    return build_sketch(method, graph, budget=int(ratio * graph.n_nodes),
                        seed=seed, device=device)


def train_eval(graph, sketch, test_edges, *, steps: int = 400, d: int = 64,
               batch: int = 2048, lr: float = 5e-3, seed: int = 0,
               max_users: int = 2000, device="cuda"):
    """(metrics, trainer): LightGCN + BPR for ``steps``, then Recall and
    NDCG@20 over at most ``max_users`` test users. ``train_s`` is the
    training's seconds and ``params`` the trainable parameters."""
    cfg = TrainConfig(dim=d, steps=steps, batch_size=batch, lr=lr, seed=seed)
    tr = Trainer(graph, sketch, cfg, device=device)
    t0 = now()
    tr.run(log_every=0)
    train_s = now() - t0
    m = tr.evaluate(test_edges, max_users=max_users)
    m["train_s"] = train_s
    m["params"] = tr.n_params()
    return m, tr


def cluster_metrics(graph, sketch):
    """Gini / ACCL / intra-edge stats. Uses the SHARED-id-space labels
    when the method kept them (per-side compaction loses cross-side
    co-membership; hashing methods genuinely have none)."""
    lu = sketch.user_idx[:, 0].astype(np.int64)
    lv = sketch.item_idx[:, 0].astype(np.int64) + sketch.k_users
    if sketch.meta and "joint_labels" in sketch.meta:
        labels = np.asarray(sketch.meta["joint_labels"], np.int32)
    else:
        labels = np.concatenate([lu, lv]).astype(np.int32)
    sizes = M.cluster_sizes(labels)
    return {
        "gini_all": M.gini(sizes),
        "gini_users": M.gini(M.cluster_sizes(lu)),
        "gini_items": M.gini(M.cluster_sizes(lv - sketch.k_users)),
        "accl": M.accl(graph, labels),
        "intra_frac": M.intra_edges(graph, labels) / max(graph.n_edges, 1),
        "k_users": sketch.k_users, "k_items": sketch.k_items,
    }


def timed(fn, *args, repeats: int = 1, **kw):
    """(last output, seconds a call) of ``fn(*args, **kw)``; the device
    is synchronized before both clock reads."""
    t0 = now()
    out = None
    for _ in range(repeats):
        out = fn(*args, **kw)
    return out, (now() - t0) / repeats


def main(run, argv=None, doc: Optional[str] = None) -> int:
    """``python -m repro_torch.launch.paper.<module> [--full] [--device
    cuda|cpu]``: one module's rows on stdout, nothing recorded (the
    suite records)."""
    p = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--full", action="store_true",
                   help="paper-scale datasets (default: the fast ones)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; without a CUDA device the "
                        "run raises unless cpu is asked for")
    args = p.parse_args(argv)
    run(fast=not args.full, device=str(resolve_device(args.device)))
    return 0

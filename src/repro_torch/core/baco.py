"""BACO top level — thin wrappers over the ClusterEngine (port of
``repro.core.baco``, with ``solver="torch"`` and ``device=`` in place of
the reference's ``solver="jax"``).

  * gamma given     -> run the solver, report whatever K comes out;
  * gamma=None      -> log-grid search keeping the partition with the
                       best bipartite modularity among those fitting the
                       budget (``ClusterEngine.fit_gamma``).

SCU (Alg. 2): with secondary user sketches the budget is tightened to
B' = (B*d - |U|)/d, then ONE extra user half-step over the converged
labels yields the secondary assignment; primary+secondary user labels
are compacted jointly so both index one user codebook.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .engine import ClusterEngine
from .graph import BipartiteGraph
from .sketch import Sketch

__all__ = ["baco_build", "fit_gamma", "secondary_user_labels"]


def fit_gamma(graph: BipartiteGraph, wu, wv, budget: int, *,
              max_iters: int = 8, solver: str = "torch",
              grid: int = 10, gamma0: float = 1.0,
              warm_start: bool = True, batched: bool = False,
              device="cuda") -> Tuple[float, np.ndarray, int]:
    """ClusterEngine.fit_gamma with the reference's signature."""
    return ClusterEngine(solver=solver, device=device).fit_gamma(
        graph, wu, wv, budget, max_iters=max_iters, grid=grid,
        gamma0=gamma0, warm_start=warm_start, batched=batched)


def secondary_user_labels(graph: BipartiteGraph, labels: np.ndarray,
                          wu, wv, gamma: float, solver: str = "torch",
                          device="cuda") -> np.ndarray:
    """ClusterEngine.secondary_user_labels with the reference's
    signature."""
    return ClusterEngine(solver=solver, device=device).secondary_user_labels(
        graph, labels, wu, wv, gamma)


def baco_build(graph: BipartiteGraph, *, d: int = 64,
               budget: Optional[int] = None, ratio: float = 0.25,
               gamma: Optional[float] = None, scheme: str = "hws",
               solver: str = "torch", max_iters: int = 8, scu: bool = True,
               batched_gamma: bool = False, device="cuda") -> Sketch:
    """ClusterEngine.build with the reference's signature."""
    return ClusterEngine(solver=solver, device=device).build(
        graph, d=d, budget=budget, ratio=ratio, gamma=gamma, scheme=scheme,
        max_iters=max_iters, scu=scu, batched_gamma=batched_gamma)

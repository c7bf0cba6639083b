"""Incremental membership: cold-start assignment + budgeted warm refresh
(port of ``repro.stream.assign``).

Two speeds of clustering for a live stream (PAPER.md §4.3 — the cheap
LP solver is what makes periodic re-grouping affordable):

  * ``ColdStartAssigner.assign`` — per event batch: place brand-new
    users/items into the existing partition with ONE LP half-step over
    only their incident edges (``core.solver_torch.lp_cold_assign``, on
    the engine's device). The volume-balance term is kept: without it
    every cold node would sink into the hottest cluster its neighbors
    touch.
  * ``ColdStartAssigner.refresh`` — periodically: a budgeted solve over
    the grown graph, warm-started from the current labels (label
    propagation only merges into existing neighbor labels, so a warm
    start is safe and usually converges in a few sweeps), reporting
    per-side label churn.

Labels live in the shared node-id space [0, n_nodes). ``grow_labels``
extends a label vector to a grown universe, giving each new node a
fresh singleton label from the newly created id range — ids the old
partition cannot contain, so no accidental merges. Every time here is a
host clock read after the labels came back to the host (a device
synchronize).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import ClusterEngine, make_weights, solver_torch
from repro_torch.core.graph import BipartiteGraph
from repro_torch.obs import clock
from repro_torch.obs.trace import get_tracer

__all__ = ["ColdStartAssigner", "AssignStats", "RefreshStats",
           "grow_labels"]


def grow_labels(labels: np.ndarray, old_n_users: int, old_n_items: int,
                n_users: int, n_items: int) -> np.ndarray:
    """Extend a shared-id-space label vector [old_nu + old_nv] to a
    grown universe [nu + nv], preserving old assignments and giving the
    new nodes fresh singleton labels.

    Fresh ids are allocated from [old_n, n): labels always satisfy
    ``label < n_nodes`` (LP never mints ids — it only adopts existing
    neighbor labels), so the new range cannot collide with any live
    cluster id.
    """
    labels = np.asarray(labels, np.int32)
    old_n = old_n_users + old_n_items
    if labels.shape[0] != old_n:
        raise ValueError(f"labels cover {labels.shape[0]} nodes, "
                         f"expected {old_n}")
    if n_users < old_n_users or n_items < old_n_items:
        raise ValueError("universe cannot shrink")
    fresh = np.arange(old_n, n_users + n_items, dtype=np.int32)
    d_users = n_users - old_n_users
    return np.concatenate([labels[:old_n_users], fresh[:d_users],
                           labels[old_n_users:], fresh[d_users:]])


@dataclasses.dataclass(frozen=True)
class AssignStats:
    n_new_users: int
    n_new_items: int
    adopted_users: int      # cold users that joined an existing cluster
    adopted_items: int
    ms: float               # wall time of the assignment


@dataclasses.dataclass(frozen=True)
class RefreshStats:
    iters: int
    churn_users: float      # fraction of pre-existing users relabeled
    churn_items: float
    ms: float
    gamma: float = 1.0      # resolution the chosen partition solved at


@dataclasses.dataclass
class ColdStartAssigner:
    """Places arriving nodes and periodically re-groups the graph.

    engine: the ClusterEngine used for refresh solves; its ``device``
            runs the cold half-steps and capped solves too, and its
            ``stats`` count their sweeps and host syncs. stream/ is,
            with core/, the only layer that calls solver internals.
    scheme: weight scheme (must match the scheme the partition was
            built with, or the balance term is inconsistent).
    gamma:  resolution the partition was solved at.
    caps:   optional {"n_users","n_items","n_edges"} maxima: refresh
            solves then go through ``lp_solve_capped``, as the
            reference's do (here it solves unpadded; labels are the
            same either way).
    """

    engine: ClusterEngine = dataclasses.field(default_factory=ClusterEngine)
    scheme: str = "hws"
    gamma: float = 1.0
    caps: Optional[dict] = None

    def assign(self, graph: BipartiteGraph, labels: np.ndarray,
               n_new_users: int, n_new_items: int,
               ) -> Tuple[np.ndarray, AssignStats]:
        """One cold-start half-step per side over the grown graph.

        ``labels`` must already be grown (``grow_labels``) — a
        zero-delta call (no new nodes) is a strict label no-op.

        With ``engine.candidates == "minhash"`` the half-step scores
        only each cold node's minhash candidate labels
        (``core.candidates.cold_candidate_sets``), identical to exact
        whenever the true argmax is in the candidate set.
        """
        labels = np.asarray(labels, np.int32)
        if n_new_users == 0 and n_new_items == 0:
            return labels, AssignStats(0, 0, 0, 0, 0.0)
        t0 = clock.now()
        with get_tracer().span("cold_assign", n_new_users=int(n_new_users),
                               n_new_items=int(n_new_items)):
            wu, wv = make_weights(graph, self.scheme)
            cand = None
            if self.engine.candidates == "minhash":
                from repro_torch.core.candidates import cold_candidate_sets
                cand = cold_candidate_sets(graph, labels, n_new_users,
                                           n_new_items)
            out = solver_torch.lp_cold_assign(
                graph, labels, wu, wv, self.gamma, n_new_users, n_new_items,
                cand_labels=cand, device=self.engine.device,
                stats=self.engine.stats)
        ms = clock.ms_between(t0, clock.now())
        nu = graph.n_users
        moved_u = int(np.sum(out[nu - n_new_users:nu]
                             != labels[nu - n_new_users:nu]))
        moved_v = int(np.sum(out[-n_new_items:] != labels[-n_new_items:])
                      if n_new_items else 0)
        return out, AssignStats(int(n_new_users), int(n_new_items),
                                moved_u, moved_v, ms)

    def _solve(self, graph, wu, wv, gamma, budget, max_iters, init):
        if self.caps is not None:
            return solver_torch.lp_solve_capped(
                graph, wu, wv, gamma, budget, max_iters, init_labels=init,
                caps=self.caps, device=self.engine.device,
                stats=self.engine.stats)
        return self.engine.solve(graph, wu, wv, gamma, budget, max_iters,
                                 init_labels=init)

    def refresh(self, graph: BipartiteGraph, labels: np.ndarray,
                budget: Optional[int] = None, max_iters: int = 8,
                probe_gamma: bool = True,
                ) -> Tuple[np.ndarray, RefreshStats]:
        """Budgeted warm-started re-grouping of the WHOLE grown graph.

        Warm-starting from the live labels means a drift-free stream
        converges in one sweep (the sweep that detects the fixed point);
        churn is reported against the warm-start labels.

        probe_gamma: also continue the warm chain DOWNWARD — solve at
        gamma/2 seeded by the gamma result, then gamma/4 seeded by that —
        and keep the most-modular within-budget partition (the proxy
        fit_gamma selects by). Label propagation merges labels but never
        splits, so downward is the only direction a warm start can
        probe. The winning gamma becomes the assigner's resolution.

        With ``engine.candidates == "minhash"`` the sweeps run over a
        candidate-pruned copy of the graph (``core.candidates.
        prune_graph``, built once per refresh from the warm-start
        labels); churn and the modularity that selects gamma are still
        measured on the full graph.
        """
        from repro_torch.core.metrics import bipartite_modularity
        labels = np.asarray(labels, np.int32)
        t0 = clock.now()
        solve_graph = graph
        if self.engine.candidates == "minhash":
            from repro_torch.core.candidates import prune_graph
            solve_graph, _kept = prune_graph(graph, labels)
        wu, wv = make_weights(graph, self.scheme)
        nu = graph.n_users
        gammas = [self.gamma] + ([self.gamma / 2.0, self.gamma / 4.0]
                                 if probe_gamma else [])
        primary = None
        best = None
        seed = labels
        for g in gammas:
            with get_tracer().span("refresh_probe", gamma=float(g)):
                new, iters = self._solve(solve_graph, wu, wv, g, budget,
                                         max_iters, seed)
            seed = new                  # fine -> coarse warm chain
            if primary is None:
                primary = (new, iters, g)
            k = (np.unique(new[:nu]).size + np.unique(new[nu:]).size)
            if budget is not None and k > budget:
                continue
            q = bipartite_modularity(graph, new)
            if best is None or q > best[0]:
                best = (q, new, iters, g)
        new, iters, g_best = (best[1:] if best is not None else primary)
        self.gamma = float(g_best)
        ms = clock.ms_between(t0, clock.now())
        churn_u = float(np.mean(new[:nu] != labels[:nu])) if nu else 0.0
        churn_v = float(np.mean(new[nu:] != labels[nu:])) \
            if graph.n_items else 0.0
        return new, RefreshStats(int(iters), churn_u, churn_v, ms,
                                 float(g_best))

    def secondary(self, graph: BipartiteGraph,
                  labels: np.ndarray) -> np.ndarray:
        """Re-derive secondary user clusters (SCU) for the current
        labels — required after any batch that touched users, since a
        single new item can change the runner-up ranking."""
        wu, wv = make_weights(graph, self.scheme)
        return self.engine.secondary_user_labels(graph, labels, wu, wv,
                                                 self.gamma)

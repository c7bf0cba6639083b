"""Table 11 analogue: large-scale datasets (MovieLens/SteamGame-shaped
synthetics), riding the streamed edge-block solver (port of
``benchmarks/table11_large_scale.py``).

The BACO row builds through ``ClusterEngine(solver="torch_streamed")``
so the sketch construction never holds the full edge list on the
device; ``fast=False`` runs the 1M-node ladder rung (the shape of
``repro_torch.launch.cluster_scale``'s "1m"), ``fast=True`` a
quarter-scale MovieLens-shaped graph.

Spectral co-clustering is excluded above ~1M nodes as in the paper —
but the exclusion is MEASURED here, not asserted: we time SCC on a
small size ladder, fit the log-log runtime slope, and extrapolate to
the large graph's node count. The fitted hours estimate is printed in
the exclusion row (paper reports >10h).
"""
from __future__ import annotations

import math
import sys

import numpy as np

from repro_torch.core import ClusterEngine, build_sketch
from repro_torch.launch.paper.common import Row, cluster_metrics, main, now

# small ladder for the SCC runtime fit (node counts; SVD-dominated)
SCC_FIT_SIZES = [(1_500, 500), (3_000, 1_000), (6_000, 2_000)]


def _planted(nu, nv, k, deg, seed=0):
    from repro_torch.data import planted_coclusters
    g, _, _ = planted_coclusters(nu, nv, k_true=k, avg_deg=deg, seed=seed)
    return g


def scc_exclusion(rows: Row, name: str, target_nodes: int) -> float:
    """Measure SCC on the small ladder, fit t ~ n^slope, extrapolate
    to ``target_nodes``. Returns the estimated hours."""
    ns, ts = [], []
    for i, (nu, nv) in enumerate(SCC_FIT_SIZES):
        g = _planted(nu, nv, k=24, deg=8)
        budget = int(0.125 * g.n_nodes)
        reps = 3 if i == 0 else 2   # first size also eats one-time warmup
        dt = float("inf")
        for _ in range(reps):       # best-of: strip warmup noise
            t0 = now()
            build_sketch("scc", g, budget=budget)
            dt = min(dt, now() - t0)
        ns.append(g.n_nodes)
        ts.append(max(dt, 1e-6))
        rows.add(f"table11/scc_fit/n{g.n_nodes}", dt * 1e6,
                 scc_s=round(dt, 3))
    slope, icept = np.polyfit(np.log(ns), np.log(ts), 1)
    est_h = math.exp(icept + slope * math.log(target_nodes)) / 3600.0
    rows.add(f"table11/{name}/scc", float("nan"),
             note=f"'excluded: measured t~n^{slope:.2f} extrapolates to "
                  f"~{est_h:.1f}h at n={target_nodes} (paper: >10h)'")
    return est_h


def run(fast: bool = True, device="cuda"):
    rows = Row()
    if fast:
        # fast mode: quarter-scale movielens shape
        name = "movielens_q"
        train = _planted(50_000, 16_000, k=200, deg=40)
        methods = ["baco", "louvain_modularity", "lp"]
    else:
        # the 1M-node ladder rung (cluster_scale's "1m")
        from repro_torch.launch.cluster_scale import AVG_DEG, RUNGS
        name = "ladder_1m"
        nu, nv, k = RUNGS["1m"]
        train = _planted(nu, nv, k=k, deg=AVG_DEG)
        # graph-baseline sweeps (python Louvain) do not scale here; the
        # comparison at shared sizes lives in the fast row + fig2
        methods = ["baco", "lp"]
    budget = int(0.125 * train.n_nodes)
    for m in methods:
        t0 = now()
        if m == "baco":
            # streamed solver: edges stay host-side during the solve
            sk = ClusterEngine(solver="torch_streamed", device=device).build(
                train, d=64, ratio=0.125)
        else:
            sk = build_sketch(m, train, budget=budget, device=device)
        dt = now() - t0
        cm = cluster_metrics(train, sk)
        rows.add(f"table11/{name}/{m}", dt * 1e6,
                 per_edge_us=dt / train.n_edges * 1e6,
                 params=sk.n_params(64), **cm)
    scc_exclusion(rows, name, train.n_nodes)
    return rows.emit()


if __name__ == "__main__":
    sys.exit(main(run, doc=__doc__))

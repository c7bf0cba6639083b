"""The 10k -> 100k -> 1M clustering scale ladder on the port:
``python -m repro_torch.launch.cluster_scale`` (port of the solve part
of ``benchmarks/cluster_scale_bench.py``).

Each rung is a planted-co-cluster bipartite graph at a fixed average
degree, solved by the streamed edge-block solver ("torch_streamed":
edges stay in pinned host blocks; device residency is O(nodes +
block)). Per rung the record holds:

  * the streamed solve's ``last_stats`` (blocks per side, padded block
    lengths, seconds per sweep, the fastest sweep's ms, blocks/s, peak
    device bytes: ``torch.cuda.max_memory_allocated`` on a GPU, a
    residency estimate on the CPU), its seconds and modularity;
  * while edges <= ``--inmem-max-edges``: the in-memory "torch" solve's
    seconds, whether its labels equal the streamed ones bit for bit,
    and its modularity;
  * the minhash cold-assign experiment: the last 2% of users are
    treated as cold arrivals and placed exact vs candidate-pruned
    through the stream layer's ``ColdStartAssigner`` (assign times,
    candidate build time, recall of the exact argmax, candidates per
    node against the label universe).

The reference's node-aligned vs uniform shard balance
(``shard_imbalance_*``) waits for the port of the sharding layer.

    python -m repro_torch.launch.cluster_scale --device cpu --rungs 10k
    python -m repro_torch.launch.cluster_scale --rungs 100k,1m --json

Runs on the CUDA device by default; prints one JSON record with
``--json`` (and writes it to ``--out``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# (n_users, n_items, k_true); average degree fixed across the ladder
RUNGS = {
    "10k": (8_000, 2_000, 32),
    "100k": (80_000, 20_000, 128),
    "1m": (800_000, 200_000, 512),
}
AVG_DEG = 8
GAMMA = 0.5
MAX_ITERS = 8
# the in-memory parity solve runs while the full edge list fits
INMEM_MAX_EDGES = 4_000_000
COLD_FRAC = 0.02


def build_rung(rung: str, seed: int = 0):
    """(graph, host seconds) of one rung."""
    from repro_torch.data import planted_coclusters
    nu, nv, k = RUNGS[rung]
    t0 = time.perf_counter()
    g, _, _ = planted_coclusters(nu, nv, k_true=k, avg_deg=AVG_DEG,
                                 seed=seed)
    return g, time.perf_counter() - t0


def _sync(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve_streamed(graph, wu, wv, block_edges: int, device: str):
    """(labels, sweeps, last_stats, seconds) of one streamed solve."""
    from repro_torch.core import ClusterEngine
    eng = ClusterEngine(solver="torch_streamed", block_edges=block_edges,
                        device=device)
    t0 = time.perf_counter()
    labels, sweeps = eng.solve(graph, wu, wv, GAMMA, max_iters=MAX_ITERS)
    _sync(device)
    return labels, sweeps, dict(eng.resolve().last_stats), \
        time.perf_counter() - t0


def solve_inmem(graph, wu, wv, device: str, solver: str = "torch"):
    """(labels, sweeps, seconds, peak device bytes or None) of one
    in-memory solve, from a reset peak on a graph with no device edge
    lists (dropped again after, so the ladder's later phases start
    clean)."""
    import torch

    from repro_torch.core import ClusterEngine
    on_gpu = torch.device(device).type == "cuda"
    ClusterEngine.drop_device_edges(graph)
    if on_gpu:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    eng = ClusterEngine(solver=solver, device=device)
    t0 = time.perf_counter()
    labels, sweeps = eng.solve(graph, wu, wv, GAMMA, max_iters=MAX_ITERS)
    _sync(device)
    seconds = time.perf_counter() - t0
    peak = int(torch.cuda.max_memory_allocated()) if on_gpu else None
    ClusterEngine.drop_device_edges(graph)
    return labels, sweeps, seconds, peak


def _best_of_2(fn):
    dt = float("inf")
    out = None
    for _ in range(2):
        t0 = time.perf_counter()
        out = fn()
        dt = min(dt, time.perf_counter() - t0)
    return out, max(dt, 1e-9)


def cold_experiment(graph, labels, device: str) -> dict:
    """Forget the last 2% of users and place them again, exact vs
    minhash-pruned, through the stream layer's ``ColdStartAssigner``.
    The candidate index build (``cand_ms``) is reported apart from the
    pruned assignment: a stream builds it once per refresh. Assign
    times are best of 2."""
    from repro_torch.core import ClusterEngine
    from repro_torch.core import candidates as cd
    from repro_torch.stream.assign import ColdStartAssigner
    nu = graph.n_users
    n_cold = max(1, int(nu * COLD_FRAC))
    lab = np.asarray(labels, np.int32).copy()
    lab[nu - n_cold:nu] = np.arange(nu - n_cold, nu, dtype=np.int32)
    n_labels = int(np.unique(lab[:nu - n_cold]).size
                   + np.unique(lab[nu:]).size)

    exact_asgn = ColdStartAssigner(gamma=GAMMA,
                                   engine=ClusterEngine(device=device))
    (exact, _), exact_s = _best_of_2(
        lambda: exact_asgn.assign(graph, lab, n_cold, 0))
    t0 = time.perf_counter()
    cand = cd.cold_candidate_sets(graph, lab, n_new_users=n_cold)
    cand_s = time.perf_counter() - t0
    mh_asgn = ColdStartAssigner(
        gamma=GAMMA, engine=ClusterEngine(candidates="minhash",
                                          device=device))
    (pruned, _), total_s = _best_of_2(
        lambda: mh_asgn.assign(graph, lab, n_cold, 0))

    cold = slice(nu - n_cold, nu)
    recall = cd.candidate_recall(cand["user"], exact[cold], lab[cold])
    per_node = np.diff(cand["user"][1])
    deg = np.diff(graph.user_csr()[0][nu - n_cold:])
    return {
        "n_cold_users": int(n_cold),
        "n_labels": n_labels,
        "exact_ms": exact_s * 1e3,
        "cand_ms": cand_s * 1e3,
        "minhash_total_ms": total_s * 1e3,
        "cand_us_per_node": cand_s / n_cold * 1e6,
        "minhash_recall": float(recall),
        "agree_frac": float(np.mean(pruned[cold] == exact[cold])),
        "mean_candidates": float(per_node.mean()),
        "cand_frac_of_labels": float(per_node.mean()) / n_labels,
        "max_candidates": int(per_node.max()) if per_node.size else 0,
        "mean_cold_degree": float(deg.mean()),
    }


def bench_rung(rung: str, block_edges: int, inmem_max_edges: int,
               device: str, log=print) -> dict:
    """One rung's record (the reference's keys, less the shard
    balance)."""
    from repro_torch.core import make_weights
    from repro_torch.core.metrics import bipartite_modularity

    g, build_s = build_rung(rung)
    wu, wv = make_weights(g, "hws")
    log(f"[scale] {rung}: n={g.n_nodes} e={g.n_edges} "
        f"(built in {build_s:.1f}s)")
    labels, sweeps, stats, total_s = solve_streamed(g, wu, wv, block_edges,
                                                    device)
    rec = {"rung": rung, "n_nodes": g.n_nodes, "n_edges": g.n_edges,
           "build_s": build_s, "solve_s": total_s,
           "modularity": bipartite_modularity(g, labels), **stats}
    log(f"[scale] {rung}: streamed {sweeps} sweeps in {total_s:.2f}s "
        f"(fastest sweep {stats['sweep_ms']:.1f} ms, "
        f"{stats['n_blocks_user'] + stats['n_blocks_item']} blocks, "
        f"peak {stats['peak_device_bytes'] / 1e6:.0f} MB "
        f"[{stats['peak_bytes_source']}])")
    if g.n_edges <= inmem_max_edges:
        ref, _, inmem_s, _ = solve_inmem(g, wu, wv, device)
        rec["inmem_solve_s"] = inmem_s
        rec["bitwise_equal_inmem"] = bool(np.array_equal(labels, ref))
        rec["modularity_inmem"] = bipartite_modularity(g, ref)
        log(f"[scale] {rung}: in-memory parity "
            f"bitwise={rec['bitwise_equal_inmem']}")
    rec["cold"] = c = cold_experiment(g, labels, device)
    log(f"[scale] {rung}: cold-assign {c['n_cold_users']} users, "
        f"labels={c['n_labels']}, candidates/node={c['mean_candidates']:.1f} "
        f"({c['cand_frac_of_labels']:.2%} of labels) "
        f"recall={c['minhash_recall']:.4f} [exact {c['exact_ms']:.2f}ms, "
        f"fit+query {c['cand_ms']:.2f}ms, total "
        f"{c['minhash_total_ms']:.2f}ms]")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--rungs", default="10k,100k",
                    help=f"comma list from {sorted(RUNGS)}")
    ap.add_argument("--block-edges", type=int, default=1 << 20)
    ap.add_argument("--inmem-max-edges", type=int, default=INMEM_MAX_EDGES,
                    help="run the in-memory parity solve up to this many "
                         "edges")
    ap.add_argument("--json", action="store_true",
                    help="print the record as one JSON line")
    ap.add_argument("--out", default=None, help="also write the record here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        ap.error(f"unknown rungs {unknown}; choose from {sorted(RUNGS)}")
    if args.block_edges <= 0:
        ap.error("--block-edges must be positive")
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    recs = [bench_rung(r, args.block_edges, args.inmem_max_edges, str(dev))
            for r in rungs]
    record = {"bench": "cluster_scale",
              "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "gamma": GAMMA, "avg_deg": AVG_DEG,
              "block_edges": int(args.block_edges), "rungs": recs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    if args.json:
        print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

  * the shard balance at 8 shards (:func:`shard_balance`, host numpy):
    the largest shard's edge count over the mean for uniform node ranges
    (``shard_imbalance_uniform``) and for node-aligned edge-balanced
    bounds (``shard_imbalance_aligned``).

    python -m repro_torch.launch.cluster_scale --device cpu --rungs 10k
    python -m repro_torch.launch.cluster_scale --rungs 100k,1m --json

Runs on the CUDA device by default. The record (bench ``cluster_scale``)
goes to the port's results store through ``repro_torch.results.BenchRun``
with the reference's config dict and headline metrics
(:func:`ladder_metrics`); ``--json`` prints it as one JSON line and
``--out`` writes it to a file.
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.launch.rows import Row
from repro_torch.obs import clock
from repro_torch.results import BenchRun, higher, lower

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
    t0 = clock.now()
    g, _, _ = planted_coclusters(nu, nv, k_true=k, avg_deg=AVG_DEG,
                                 seed=seed)
    return g, clock.now() - t0


def _sync(device: str) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def solve_streamed(graph, wu, wv, block_edges: int, device: str):
    """(labels, sweeps, last_stats, seconds) of one streamed solve."""
    from repro_torch.core import ClusterEngine
    eng = ClusterEngine(solver="torch_streamed", block_edges=block_edges,
                        device=device)
    t0 = clock.now()
    labels, sweeps = eng.solve(graph, wu, wv, GAMMA, max_iters=MAX_ITERS)
    _sync(device)
    return labels, sweeps, dict(eng.resolve().last_stats), \
        clock.now() - t0


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
    t0 = clock.now()
    labels, sweeps = eng.solve(graph, wu, wv, GAMMA, max_iters=MAX_ITERS)
    _sync(device)
    seconds = clock.now() - t0
    peak = int(torch.cuda.max_memory_allocated()) if on_gpu else None
    ClusterEngine.drop_device_edges(graph)
    return labels, sweeps, seconds, peak


def shard_balance(graph, n_shards: int = 8):
    """(uniform, aligned): max/mean per-shard edge count for uniform node
    ranges and for the node-aligned edge-balanced bounds that
    ``edge_partition(bounds=...)`` takes (the reference's
    ``_shard_balance``)."""
    from repro_torch.core.graph import node_aligned_bounds
    from repro_torch.distributed.sharding import edge_partition
    indptr = graph.user_csr()[0]
    e = graph.n_edges
    if e == 0:
        return 1.0, 1.0
    nps = -(-graph.n_users // n_shards)
    cuts = np.minimum(np.arange(n_shards + 1, dtype=np.int64) * nps,
                      graph.n_users)
    uni = np.diff(indptr[cuts]).astype(np.float64)
    bounds = node_aligned_bounds(indptr, -(-e // n_shards))
    # the composed partition validates the bounds' node alignment
    edge_partition(graph.edge_u, graph.edge_v, graph.n_users,
                   bounds.size - 1, bounds=bounds)
    ali = np.diff(bounds).astype(np.float64)
    mean = e / n_shards
    return float(uni.max() / mean), float(ali.max() / mean)


def _best_of_2(fn):
    dt = float("inf")
    out = None
    for _ in range(2):
        t0 = clock.now()
        out = fn()
        dt = min(dt, clock.now() - t0)
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
    t0 = clock.now()
    cand = cd.cold_candidate_sets(graph, lab, n_new_users=n_cold)
    cand_s = clock.now() - t0
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
    """One rung's record (the reference's keys)."""
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
    rec["shard_imbalance_uniform"], rec["shard_imbalance_aligned"] = \
        shard_balance(g)
    rec["cold"] = c = cold_experiment(g, labels, device)
    log(f"[scale] {rung}: cold-assign {c['n_cold_users']} users, "
        f"labels={c['n_labels']}, candidates/node={c['mean_candidates']:.1f} "
        f"({c['cand_frac_of_labels']:.2%} of labels) "
        f"recall={c['minhash_recall']:.4f} [exact {c['exact_ms']:.2f}ms, "
        f"fit+query {c['cand_ms']:.2f}ms, total "
        f"{c['minhash_total_ms']:.2f}ms]")
    return rec


def run(fast: bool = True, device="cuda"):
    """The paper suite's entry (``launch.paper.run``): CSV rows for the
    CI-sized rungs, nothing recorded (the reference's
    ``cluster_scale_bench.run``)."""
    rows = Row()
    for r in (["10k"] if fast else ["10k", "100k"]):
        rec = bench_rung(r, 1 << 20, INMEM_MAX_EDGES, device)
        cold = rec.pop("cold")
        rows.add(f"cluster_scale/{rec['rung']}/streamed",
                 rec["sweep_ms"] * 1e3,
                 sweeps=rec["sweeps"], blocks_per_s=rec["blocks_per_s"],
                 peak_mb=round(rec["peak_device_bytes"] / 1e6, 1),
                 bitwise=rec.get("bitwise_equal_inmem", "n/a"))
        rows.add(f"cluster_scale/{rec['rung']}/cold_minhash",
                 cold["minhash_total_ms"] * 1e3,
                 cand_ms=cold["cand_ms"],
                 recall=cold["minhash_recall"],
                 mean_candidates=cold["mean_candidates"],
                 n_labels=cold["n_labels"])
    return rows.emit()


def ladder_metrics(rungs) -> dict:
    """Declared-direction headline metrics over the ladder rungs (the
    reference's)."""
    out = {}
    recalls, bitwise = [], []
    for r in rungs:
        if not isinstance(r, dict):
            continue
        tag = r.get("rung", "?")
        if isinstance(r.get("sweep_ms"), (int, float)):
            out[f"{tag}_sweep_ms"] = lower(r["sweep_ms"])
        if isinstance(r.get("peak_device_bytes"), (int, float)):
            out[f"{tag}_peak_mb"] = lower(
                round(r["peak_device_bytes"] / 1e6, 1))
        if isinstance(r.get("blocks_per_s"), (int, float)):
            out[f"{tag}_blocks_per_s"] = higher(r["blocks_per_s"])
        if isinstance(r.get("cold"), dict) \
                and isinstance(r["cold"].get("minhash_recall"),
                               (int, float)):
            recalls.append(r["cold"]["minhash_recall"])
        if "bitwise_equal_inmem" in r:
            bitwise.append(bool(r["bitwise_equal_inmem"]))
    if recalls:
        out["min_minhash_recall"] = higher(min(recalls))
    if bitwise:
        out["bitwise_parity_ok"] = higher(int(all(bitwise)))
    return out


def main(argv=None) -> int:
    run_ = BenchRun("cluster_scale", description=__doc__)
    run_.add_argument("--rungs", default="10k,100k",
                      help=f"comma list from {sorted(RUNGS)}")
    run_.add_argument("--block-edges", type=int, default=1 << 20)
    run_.add_argument("--inmem-max-edges", type=int,
                      default=INMEM_MAX_EDGES,
                      help="run the in-memory parity solve up to this many "
                           "edges")
    args = run_.parse(argv)
    rungs = [r.strip() for r in args.rungs.split(",") if r.strip()]
    unknown = [r for r in rungs if r not in RUNGS]
    if unknown:
        run_.parser.error(f"unknown rungs {unknown}; "
                          f"choose from {sorted(RUNGS)}")
    if args.block_edges <= 0:
        run_.parser.error("--block-edges must be positive")
    config = {"rungs": rungs, "gamma": GAMMA, "avg_deg": AVG_DEG,
              "max_iters": MAX_ITERS,
              "block_edges": int(args.block_edges),
              "inmem_max_edges": int(args.inmem_max_edges),
              "cold_frac": COLD_FRAC}
    hit = run_.cached(config)
    if hit is not None:
        run_.replay(hit)
        return 0
    import torch
    dev = run_.device
    with run_.profile("ladder"):
        recs = [bench_rung(r, args.block_edges, args.inmem_max_edges,
                           str(dev)) for r in rungs]
    record = {"bench": "cluster_scale",
              "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "gamma": GAMMA, "avg_deg": AVG_DEG,
              "block_edges": int(args.block_edges), "rungs": recs}
    run_.emit(config, ladder_metrics(recs), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

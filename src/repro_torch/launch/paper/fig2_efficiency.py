"""Figure 2 analogue: sketching-construction runtime of strong methods.
BACO's LP solver vs Louvain (GraphHash) vs spectral co-clustering — the
paper's headline is up-to-346x vs SCC; we report every registered
ClusterEngine solver (numpy sequential = paper Alg.1; torch = the
device-resident loop; torch_hostloop = the host-driven loop;
torch_sharded = the edge-partitioned solve over the ranks of a
``torch.distributed`` world, here a world of 1; torch_streamed =
host-resident edges streamed through per-block launches). Port of
``benchmarks/fig2_efficiency.py``; the reference's ``jax*`` solvers are
the port's ``torch*`` ones (:data:`SOLVER_NAMES`).

``--sizes NUxNVxKxDEG,...`` overrides the built-in solve-sweep ladder;
for the dedicated 10k/100k/1M ladder with memory + parity tracking see
``repro_torch.launch.cluster_scale``.

``python -m repro_torch.launch.paper.fig2_efficiency --json [--out F]``
records the machine-readable sweep (bench ``cluster_solve``) through
``repro_torch.results.BenchRun``:

    {"bench": "cluster_solve", "platform": ..., "device": ...,
     "records": [
       {"kind": "solve", "solver", "n_nodes", "n_edges", "solve_s",
        "iters"}, ...
       {"kind": "grid_search", "mode": "hostloop_sequential" |
        "device_sequential" | "device_batched", "n_nodes", "wall_s",
        "gamma", "speedup_vs_hostloop"}, ...]}

The three grid-search modes solve the same subproblems from a cold
start, so they must select the same gamma: the reference's acceptance
signal for the device-resident loop. Without ``--json``, ``--out`` or
``--profile`` the module prints :func:`run`'s rows (the suite's entry).
"""
from __future__ import annotations

import sys

from repro_torch.core import ClusterEngine, build_sketch, make_weights
from repro_torch.launch.paper.common import Row, get_dataset, now
from repro_torch.results import BenchRun, higher, lower

# solve-time sweep sizes (n_users, n_items, k_true, avg_deg); the numpy
# Alg.1 python sweep only runs on graphs below this node count
NUMPY_MAX_NODES = 8_000
SIZES_FAST = [(2_000, 1_500, 24, 12), (12_000, 6_000, 80, 18)]
SIZES_FULL = SIZES_FAST + [(60_000, 24_000, 200, 24)]
GAMMA = 8.0
SOLVERS = ["torch", "torch_hostloop", "torch_sharded", "torch_streamed"]
# the reference's solver names and the port's
SOLVER_NAMES = {"jax": "torch", "jax_hostloop": "torch_hostloop",
                "jax_sharded": "torch_sharded",
                "jax_streamed": "torch_streamed", "numpy": "numpy"}


def parse_sizes(spec: str):
    """'2000x1500x24x12,...' -> [(n_users, n_items, k_true, avg_deg)]."""
    out = []
    for part in spec.split(","):
        dims = tuple(int(t) for t in part.strip().split("x"))
        if len(dims) != 4 or min(dims) <= 0:
            raise ValueError(f"bad --sizes entry {part!r}; "
                             f"expected NUxNVxKxDEG of positive ints")
        out.append(dims)
    if not out:
        raise ValueError("--sizes parsed to an empty list")
    return out


def _graphs(fast: bool, sizes=None):
    from repro_torch.data import planted_coclusters
    if sizes is None:
        sizes = SIZES_FAST if fast else SIZES_FULL
    for nu, nv, k, deg in sizes:
        g, _, _ = planted_coclusters(nu, nv, k_true=k, avg_deg=deg,
                                     seed=0)
        yield g


def _timed_solve(engine, graph, wu, wv, budget):
    engine.solve(graph, wu, wv, GAMMA, budget, 8)      # warmup/compile
    dt, iters = float("inf"), 0
    for _ in range(2):                      # best-of-2: steady state
        t0 = now()
        _, iters = engine.solve(graph, wu, wv, GAMMA, budget, 8)
        dt = min(dt, now() - t0)
    return dt, iters


def _solve_time(name, graph, wu, wv, budget, device):
    """(seconds, iters) of one solver; the sharded one inside a world
    (of 1 when no launcher made one), as it raises outside any."""
    engine = ClusterEngine(solver=name, device=device)
    if name != "torch_sharded":
        return _timed_solve(engine, graph, wu, wv, budget)
    from repro_torch.distributed import world
    with world(device):
        return _timed_solve(engine, graph, wu, wv, budget)


def bench(fast: bool = True, sizes=None, device="cuda"):
    """-> list of JSON-able solve / grid_search records."""
    records = []
    last_graph = None
    for g in _graphs(fast, sizes):
        last_graph = g
        wu, wv = make_weights(g, "hws")
        budget = int(0.25 * g.n_nodes)
        solvers = list(SOLVERS)
        if g.n_nodes <= NUMPY_MAX_NODES:
            solvers.append("numpy")
        for name in solvers:
            dt, iters = _solve_time(name, g, wu, wv, budget, device)
            records.append({"kind": "solve", "solver": name,
                            "n_nodes": g.n_nodes, "n_edges": g.n_edges,
                            "solve_s": round(dt, 4), "iters": int(iters)})
            print(f"[cluster] solve {name:15s} n={g.n_nodes:7d} "
                  f"e={g.n_edges:8d}: {dt*1e3:8.1f} ms ({iters} iters)",
                  flush=True)

    # grid search on the largest graph: the host-driven walk vs the
    # device-resident sequential walk vs the batched grid (cold start in
    # all three so the solved subproblems are identical and the
    # selected gamma must agree)
    g = last_graph
    wu, wv = make_weights(g, "hws")
    budget = int(0.25 * g.n_nodes)
    modes = [("hostloop_sequential",
              ClusterEngine(solver="torch_hostloop", device=device), {}),
             ("device_sequential",
              ClusterEngine(solver="torch", device=device), {}),
             ("device_batched",
              ClusterEngine(solver="torch", device=device),
              {"batched": True, "lanes": 10})]
    base = None
    for mode, engine, kw in modes:
        engine.fit_gamma(g, wu, wv, budget, warm_start=False, grid=10,
                         **kw)                          # warmup
        dt, gamma = float("inf"), None
        for _ in range(2):                  # best-of-2: steady state
            t0 = now()
            gamma, _, _ = engine.fit_gamma(g, wu, wv, budget,
                                           warm_start=False, grid=10, **kw)
            dt = min(dt, now() - t0)
        if base is None:
            base = dt
        records.append({"kind": "grid_search", "mode": mode,
                        "n_nodes": g.n_nodes, "wall_s": round(dt, 4),
                        "gamma": gamma,
                        "speedup_vs_hostloop": round(base / dt, 2)})
        print(f"[cluster] grid  {mode:20s} n={g.n_nodes:7d}: "
              f"{dt:7.2f} s  gamma={gamma}  x{base/dt:.2f} vs hostloop",
              flush=True)
    return records


def run(fast: bool = True, device="cuda"):
    rows = Row()
    datasets = ["gowalla_s"] if fast else ["gowalla", "amazonbook"]
    for ds in datasets:
        _, _, _, train, _ = get_dataset(ds)
        budget = int(0.25 * train.n_nodes)

        t0 = now()
        ClusterEngine(solver="torch", device=device).build(train, d=64,
                                                           ratio=0.25)
        t_dev = now() - t0
        rows.add(f"fig2/{ds}/baco_torch", t_dev * 1e6,
                 per_edge_us=t_dev / train.n_edges * 1e6)

        t0 = now()
        ClusterEngine(solver="numpy", device=device).build(train, d=64,
                                                           ratio=0.25)
        t_np = now() - t0
        rows.add(f"fig2/{ds}/baco_seq(alg1)", t_np * 1e6,
                 per_edge_us=t_np / train.n_edges * 1e6)

        # as in the reference, the speedup is over the sequential Alg.1
        for m in ["lp", "louvain_modularity", "scc", "sbc"]:
            t0 = now()
            build_sketch(m, train, budget=budget, device=device)
            dt = now() - t0
            rows.add(f"fig2/{ds}/{m}", dt * 1e6,
                     per_edge_us=dt / train.n_edges * 1e6,
                     speedup_vs_baco=dt / max(t_np, 1e-9))
    return rows.emit()


def solve_metrics(records) -> dict:
    """Declared-direction headline metrics: grid-search speedup of the
    batched device walk, plus the largest-graph solve time per solver."""
    rows = [r for r in records if isinstance(r, dict)]
    out = {"records": higher(len(rows))}
    grid = [r for r in rows if r.get("kind") == "grid_search"
            and isinstance(r.get("speedup_vs_hostloop"), (int, float))]
    if grid:
        out["best_grid_speedup_vs_hostloop"] = higher(
            max(r["speedup_vs_hostloop"] for r in grid))
    solves = [r for r in rows if r.get("kind") == "solve"
              and isinstance(r.get("solve_s"), (int, float))]
    if solves:
        n_max = max(r["n_nodes"] for r in solves)
        for r in solves:
            if r["n_nodes"] == n_max:
                out[f"{r['solver']}_solve_s"] = lower(r["solve_s"])
    return out


def main(argv=None):
    import torch
    bench_run = BenchRun("cluster_solve", description=__doc__)
    bench_run.add_argument("--full", action="store_true",
                           help="include the largest synthetic graph")
    bench_run.add_argument("--sizes", default=None,
                           help="override the solve-sweep ladder: comma "
                                "list of NUxNVxKxDEG, e.g. "
                                "2000x1500x24x12,60000x24000x200x24")
    args = bench_run.parse(argv)
    sizes = parse_sizes(args.sizes) if args.sizes else None
    dev = bench_run.device
    if not (args.json or args.out or args.profile):
        run(fast=not args.full, device=str(dev))
        return 0
    config = {"fast": not args.full, "gamma": GAMMA,
              "sizes": sizes or (SIZES_FAST if not args.full
                                 else SIZES_FULL)}
    hit = bench_run.cached(config)
    if hit is not None:
        bench_run.replay(hit)
        return 0
    with bench_run.profile("solve_sweep"):
        records = bench(fast=not args.full, sizes=sizes, device=str(dev))
    record = {"bench": "cluster_solve",
              "platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              "gamma": GAMMA,
              "records": records}
    bench_run.emit(config, solve_metrics(records), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

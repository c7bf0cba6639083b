"""ClusterEngine: one dispatch layer for every co-clustering solve
(port of ``repro.core.engine``).

Solvers (registry):

  * "torch"          the side-synchronous LP of ``solver_torch`` on the
                     engine's device, with ``solve_many`` running a gamma
                     grid lane by lane.
  * "torch_streamed" the edge-block streamed solve
                     (``solver_torch.lp_solve_streamed``): edges stay in
                     pinned host blocks and sweep through the device, bit
                     for bit "torch" with O(nodes + block) device
                     residency — the million-node path. Sized by
                     ``ClusterEngine(block_edges=...)``; the telemetry of
                     its latest solve is the solver's ``last_stats``.
  * "torch_hostloop" the seed's half-step in a host-driven loop that
                     compares each sweep with the previous one (a
                     benchmark reference).
  * "numpy"          the paper-faithful sequential Algorithm 1 sweep
                     (``solver_numpy``, host only; ``device`` is ignored).

Only "torch" is auto-eligible, so auto-selection (solver=None/"auto")
picks it. The reference's "jax_sharded" has no counterpart yet; a
reference name raises the registry's ``KeyError``.

The engine carries its ``device`` ("cuda" unless the caller says
otherwise; a missing CUDA device raises) and a ``stats`` dict into which
every solve counts its sweeps (and the in-memory solves their host
syncs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import get_tracer

from . import solver_numpy, solver_torch
from .graph import BipartiteGraph
from .sketch import Sketch, compact_labels
from .weights import make_weights

__all__ = ["ClusterEngine", "ClusterSolver", "register_solver",
           "get_solver", "available_solvers", "normalize_solver"]


class ClusterSolver:
    """One co-clustering solve strategy. Subclass + register.

    Contract: solve() returns (labels int32[n_nodes] in the shared id
    space, iters_run); solve_many() solves a gamma grid and returns
    (labels [L, n_nodes], iters [L]); secondary() returns the SCU
    runner-up user labels.
    """
    name: str = "?"
    batched_grid: bool = False    # solve_many runs the grid in one call
    accepts_block_edges: bool = False   # solve(..., block_edges=) meaningful
    auto_eligible: bool = True    # may be picked by auto-selection

    def solve(self, graph, wu, wv, gamma, budget=None, max_iters=8,
              init_labels=None, *, device, stats):
        raise NotImplementedError

    def solve_many(self, graph, wu, wv, gammas, budget=None, max_iters=8,
                   init_labels=None, *, device, stats, **kw):
        init = None if init_labels is None else np.asarray(init_labels)
        labs, its = [], []
        for i, g in enumerate(gammas):
            seed = init[i] if init is not None and init.ndim == 2 else init
            lab, it = self.solve(graph, wu, wv, float(g), budget, max_iters,
                                 seed, device=device, stats=stats, **kw)
            labs.append(lab)
            its.append(it)
        return np.stack(labs), np.asarray(its, np.int32)

    def secondary(self, graph, labels, wu, wv, gamma, *, device):
        return _secondary_torch(graph, labels, wu, wv, gamma, device)


_REGISTRY: Dict[str, ClusterSolver] = {}


def register_solver(solver: ClusterSolver) -> ClusterSolver:
    _REGISTRY[solver.name] = solver
    return solver


def get_solver(name: str) -> ClusterSolver:
    if name not in _REGISTRY:
        raise KeyError(f"unknown cluster solver {name!r}; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_solvers():
    return tuple(sorted(_REGISTRY))


def normalize_solver(name: Optional[str]) -> Optional[str]:
    """None/"auto" -> None (auto-selection); else must be registered."""
    if name is None or name == "auto":
        return None
    get_solver(name)
    return name


class _TorchSolver(ClusterSolver):
    name = "torch"
    batched_grid = True

    def solve(self, graph, wu, wv, gamma, budget=None, max_iters=8,
              init_labels=None, *, device, stats):
        return solver_torch.lp_solve(graph, wu, wv, gamma, budget, max_iters,
                                     init_labels, device=device, stats=stats)

    def solve_many(self, graph, wu, wv, gammas, budget=None, max_iters=8,
                   init_labels=None, *, device, stats):
        return solver_torch.lp_solve_grid(graph, wu, wv, gammas, budget,
                                          max_iters, init_labels,
                                          device=device, stats=stats)


class _TorchStreamedSolver(ClusterSolver):
    name = "torch_streamed"
    accepts_block_edges = True
    auto_eligible = False     # in-memory "torch" wins whenever edges fit

    def __init__(self):
        # sweep telemetry of the latest solve (blocks, seconds per sweep,
        # peak device bytes), read by the scale CLI and the smoke
        self.last_stats: dict = {}

    def solve(self, graph, wu, wv, gamma, budget=None, max_iters=8,
              init_labels=None, *, device, stats, block_edges=None):
        last: dict = {}
        out = solver_torch.lp_solve_streamed(
            graph, wu, wv, gamma, budget, max_iters, init_labels,
            int(block_edges) if block_edges else 1 << 20, device=device,
            stats=last)
        self.last_stats = last
        stats["sweeps"] = stats.get("sweeps", 0) + int(out[1])
        return out


class _TorchHostloopSolver(ClusterSolver):
    name = "torch_hostloop"
    auto_eligible = False

    def solve(self, graph, wu, wv, gamma, budget=None, max_iters=8,
              init_labels=None, *, device, stats):
        return solver_torch.lp_solve_hostloop(graph, wu, wv, gamma, budget,
                                              max_iters, init_labels,
                                              device=device, stats=stats)


class _NumpySolver(ClusterSolver):
    name = "numpy"
    auto_eligible = False     # paper-faithful reference, orders slower

    def solve(self, graph, wu, wv, gamma, budget=None, max_iters=8,
              init_labels=None, *, device, stats):
        del device                # host numpy
        out = solver_numpy.lp_solve_sequential(graph, wu, wv, gamma, budget,
                                               max_iters,
                                               init_labels=init_labels)
        stats["sweeps"] = stats.get("sweeps", 0) + int(out[1])
        return out

    def secondary(self, graph, labels, wu, wv, gamma, *, device):
        return _secondary_numpy(graph, labels, wu, wv, gamma)


register_solver(_TorchSolver())
register_solver(_TorchHostloopSolver())
register_solver(_TorchStreamedSolver())
register_solver(_NumpySolver())


# ---------------------------------------------------------------------------
# partition scoring (k, Barber modularity) for the gamma grid
# ---------------------------------------------------------------------------
def _score_partitions(graph: BipartiteGraph, labels_batch: np.ndarray,
                      device) -> Tuple[np.ndarray, np.ndarray]:
    """(k = ku+kv, Barber modularity) per partition, f32 as the
    reference computes it.

    The degree sums per label are integers below 2^24, exact in any
    order. The reference's f32 dot ``du_k @ dv_k`` rounds in an order of
    its backend's choosing; here the dot is exact (f64 over integers)
    and rounded once to f32, so two partitions whose modularity differs
    by a few f32 ulps could rank differently than in the reference.
    """
    dev = torch.device(device)
    nu, ni, n = graph.n_users, graph.n_items, graph.n_nodes
    e = max(graph.n_edges, 1)
    eu, ev = solver_torch.device_edges(graph, dev)[:2]
    du = torch.as_tensor(graph.user_degrees(), dtype=torch.float64,
                         device=dev)
    dv = torch.as_tensor(graph.item_degrees(), dtype=torch.float64,
                         device=dev)
    ef = torch.tensor(float(e), dtype=torch.float32, device=dev)
    ks, qs = [], []
    for lab in np.asarray(labels_batch):
        lab = torch.as_tensor(lab, dtype=torch.int64, device=dev)
        lu, lv = lab[:nu], lab[nu:]
        intra = (lu[eu] == lv[ev]).sum().float()
        du_k = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, lu, du)
        dv_k = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, lv, dv)
        dot = torch.dot(du_k, dv_k).float()
        q = (intra - dot / ef) / ef
        ku, kv = solver_torch.count_side_labels(lab, nu, ni)
        ks.append(ku + kv)
        qs.append(q)
    return (torch.stack(ks).cpu().numpy().astype(np.int32),
            torch.stack(qs).cpu().numpy())


# ---------------------------------------------------------------------------
# SCU secondary assignment
# ---------------------------------------------------------------------------
def _secondary_numpy(graph: BipartiteGraph, labels, wu, wv, gamma):
    """The numpy solver's runner-up user label (f64 weight totals, the
    first maximizer among the non-primary candidates)."""
    lab = labels.astype(np.int64).copy()
    nu = graph.n_users
    u_indptr, u_nbrs = graph.user_csr()
    n = graph.n_nodes
    w_v_by_label = np.bincount(lab[nu:], weights=wv, minlength=n)
    out = lab[:nu].copy()
    for i in range(nu):
        nbrs = u_nbrs[u_indptr[i]:u_indptr[i + 1]]
        if nbrs.size == 0:
            continue
        cand, cnt = np.unique(lab[nu + nbrs], return_counts=True)
        own = lab[i]
        keep = cand != own
        if not keep.any():
            continue
        scores = (cnt - gamma * wu[i] * w_v_by_label[cand])[keep]
        out[i] = cand[keep][int(np.argmax(scores))]
    return out.astype(np.int32)


def _secondary_torch(graph: BipartiteGraph, labels, wu, wv, gamma, device):
    """Runner-up user label (the best-scoring candidate other than the
    primary; the primary when there is none). The reference runs this
    op by op, so its score is NOT a fused multiply-add: each product and
    the difference round separately, as here."""
    dev = torch.device(device)
    nu, n = graph.n_users, graph.n_nodes
    lab = torch.as_tensor(np.asarray(labels), dtype=torch.int64, device=dev)
    own = lab[:nu]
    item_labels = lab[nu:]
    eu, ev = solver_torch.device_edges(graph, dev)[:2]
    wv_t = torch.as_tensor(np.asarray(wv, np.float32), device=dev)
    wu_t = torch.as_tensor(np.asarray(wu, np.float32), device=dev)
    wv_by_label = solver_torch.segment_sum_ordered(wv_t, item_labels, n)
    e = int(eu.shape[0])
    if e == 0:
        return own.to(torch.int32).cpu().numpy()
    stride = n + 1
    key = torch.sort(eu * stride + item_labels[ev]).values
    node_s, lab_s = key // stride, key % stride
    new_grp = torch.ones(e, dtype=torch.bool, device=dev)
    new_grp[1:] = key[1:] != key[:-1]
    gid = torch.cumsum(new_grp.long(), 0) - 1
    cnt = torch.bincount(gid, minlength=e).float()[gid]
    g = torch.tensor(gamma, dtype=torch.float32, device=dev)
    score = cnt - g * wu_t[node_s] * wv_by_label[lab_s]
    score = torch.where(lab_s == own[node_s],
                        torch.full_like(score, solver_torch._NEG), score)
    best = torch.full((nu,), float("-inf"), device=dev)
    best = best.scatter_reduce(0, node_s, score, "amax", include_self=False)
    best = torch.where(torch.isfinite(best), best,
                       torch.full_like(best, solver_torch._NEG))
    is_best = (score >= best[node_s]) & (score > solver_torch._NEG)
    cand = torch.where(is_best, lab_s, torch.full_like(lab_s, n))
    best_lab = torch.full((nu,), n, dtype=torch.int64, device=dev)
    best_lab = best_lab.scatter_reduce(0, node_s, cand, "amin")
    out = torch.where(best_lab < n, best_lab, own)
    return out.to(torch.int32).cpu().numpy()


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClusterEngine:
    """Routes co-clustering work through the selected solver.

    solver: explicit override ("torch" | "torch_streamed" |
            "torch_hostloop" | "numpy" | None/"auto").
    device: where the solves run ("cuda" by default; raises without a
            CUDA device unless the caller passes "cpu").
    candidates: "exact" (default) scores every neighbor label;
            "minhash" lets the stream layer's cold-assign/refresh prune
            per-node candidates via ``core.candidates`` (``solve()``
            itself is always exact).
    block_edges: nominal edges per streamed block for "torch_streamed"
            (node-aligned; any value gives the same labels — it trades
            launches against device memory per block).
    stats:  counters every solve adds to: ``sweeps`` (LP iterations) and
            ``host_syncs`` (device-to-host reads the in-memory and
            hostloop solves need).
    """
    solver: Optional[str] = None
    device: Optional[str] = "cuda"
    candidates: str = "exact"
    block_edges: Optional[int] = None
    stats: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    def __post_init__(self):
        if self.candidates not in ("exact", "minhash"):
            raise ValueError(f"candidates must be 'exact'|'minhash', "
                             f"got {self.candidates!r}")
        if self.block_edges is not None and int(self.block_edges) <= 0:
            raise ValueError("block_edges must be positive")
        object.__setattr__(self, "device", str(resolve_device(self.device)))

    def resolve(self) -> ClusterSolver:
        if self.solver is not None and self.solver != "auto":
            return get_solver(self.solver)
        return get_solver("torch")

    @staticmethod
    def drop_device_edges(graph: BipartiteGraph) -> None:
        """Forget the device edge lists the in-memory solvers and the
        partition scoring memoized on ``graph``."""
        solver_torch.drop_device_edges(graph)

    def _kw(self, solver: ClusterSolver) -> dict:
        kw = {"device": self.device, "stats": self.stats}
        if solver.accepts_block_edges and self.block_edges:
            kw["block_edges"] = int(self.block_edges)
        return kw

    # -- one solve ---------------------------------------------------------
    def solve(self, graph: BipartiteGraph, wu, wv, gamma: float,
              budget: Optional[int] = None, max_iters: int = 8,
              init_labels=None) -> Tuple[np.ndarray, int]:
        """Run one LP solve. Returns (labels int32[n_nodes], iters)."""
        s = self.resolve()
        with get_tracer().span("cluster_solve", solver=s.name,
                               n_nodes=int(graph.n_nodes),
                               n_edges=int(graph.n_edges),
                               gamma=float(gamma)) as sp:
            labels, iters = s.solve(graph, wu, wv, gamma, budget, max_iters,
                                    init_labels, **self._kw(s))
            sp.set(iters=int(iters))
        return labels, iters

    def solve_grid(self, graph: BipartiteGraph, wu, wv, gammas,
                   budget: Optional[int] = None, max_iters: int = 8,
                   init_labels=None):
        """Solve a gamma grid. Returns (labels [L, n_nodes], iters [L])."""
        s = self.resolve()
        gammas = [float(g) for g in gammas]
        with get_tracer().span("cluster_solve_grid", solver=s.name,
                               n_nodes=int(graph.n_nodes),
                               n_gammas=len(gammas)):
            return s.solve_many(graph, wu, wv, gammas, budget, max_iters,
                                init_labels, **self._kw(s))

    # -- gamma auto-tuning -------------------------------------------------
    def fit_gamma(self, graph: BipartiteGraph, wu, wv, budget: int, *,
                  max_iters: int = 8, grid: int = 10, gamma0: float = 1.0,
                  warm_start: bool = True, batched: bool = False,
                  lanes: int = 4) -> Tuple[float, np.ndarray, int]:
        """Pick gamma on a x4-spaced log grid: the most modular partition
        with K <= budget, then probe its x2 neighbours.

        warm_start walks the grid from the LARGEST gamma down, each solve
        seeded with the previous (finer) partition. batched solves the
        grid in blocks of ``lanes`` gammas with Jacobi rounds of the
        warm-start chain (lane i seeded by lane i-1's previous round),
        stopping at the chain's fixed point — the same subproblems as the
        sequential walk, so both select identically (as in the
        reference).
        """
        s = self.resolve()
        gammas = sorted((float(gamma0) * (4.0 ** i)
                         for i in range(-3, grid - 3)), reverse=True)
        with get_tracer().span("fit_gamma", solver=s.name,
                               n_nodes=int(graph.n_nodes),
                               budget=int(budget),
                               grid=len(gammas)) as f_sp:
            solved_g, solved_lab, solved_it = [], [], []
            if batched and s.batched_grid:
                chain_seed = None
                for lo in range(0, len(gammas), max(1, lanes)):
                    chunk = gammas[lo:lo + max(1, lanes)]
                    if not warm_start:
                        labs, its = s.solve_many(graph, wu, wv, chunk, budget,
                                                 max_iters, None,
                                                 **self._kw(s))
                    else:
                        labs = its = None
                        for _ in range(len(chunk)):
                            if labs is None:
                                init = chain_seed
                            else:
                                shifted = [chain_seed if chain_seed is not None
                                           else np.arange(graph.n_nodes,
                                                          dtype=np.int32)]
                                shifted += [labs[i] for i in
                                            range(len(chunk) - 1)]
                                init = np.stack(shifted)
                            new_labs, its = s.solve_many(
                                graph, wu, wv, chunk, budget, max_iters,
                                init, **self._kw(s))
                            if labs is not None and np.array_equal(new_labs,
                                                                   labs):
                                break
                            labs = new_labs
                        chain_seed = labs[len(chunk) - 1]
                    solved_g += chunk
                    solved_lab += [labs[i] for i in range(len(chunk))]
                    solved_it += [int(its[i]) for i in range(len(chunk))]
            else:
                prev = None
                for g in gammas:
                    labels, it = self.solve(
                        graph, wu, wv, g, budget, max_iters,
                        init_labels=prev if warm_start else None)
                    if warm_start:
                        prev = labels
                    solved_g.append(g)
                    solved_lab.append(labels)
                    solved_it.append(int(it))

            ks, qs = _score_partitions(graph, np.stack(solved_lab),
                                       self.device)
            best = self._select(budget, solved_g, solved_lab, solved_it, ks, qs)
            if best is None:     # nothing within budget: closest-K fallback
                i = int(np.argmin(ks))
                f_sp.set(gamma=float(solved_g[i]), fallback=True)
                return solved_g[i], solved_lab[i], solved_it[i]

            q_best, g_best, lab_best, it_best = best
            probes = [g for g in (g_best * 2.0, g_best / 2.0)
                      if not any(np.isclose(g, gg, rtol=1e-6)
                                 for gg in solved_g)]
            if probes:
                p_lab, p_it = [], []
                for g in probes:
                    seed = None
                    if warm_start:
                        finer = [gg for gg in solved_g if gg > g]
                        if finer:
                            seed = solved_lab[solved_g.index(min(finer))]
                    lab, it = self.solve(graph, wu, wv, g, budget,
                                         max_iters, init_labels=seed)
                    p_lab.append(lab)
                    p_it.append(int(it))
                pks, pqs = _score_partitions(graph, np.stack(p_lab),
                                             self.device)
                ref = self._select(budget, probes, p_lab, p_it, pks, pqs)
                if ref is not None and ref[0] > q_best:
                    q_best, g_best, lab_best, it_best = ref
            f_sp.set(gamma=float(g_best))
            return g_best, lab_best, it_best

    @staticmethod
    def _select(budget, gs, labs, its, ks, qs):
        """(q, gamma, labels, iters) of the most-modular within-budget
        partition (first index on ties, matching walk order), or None."""
        best = None
        for i in range(len(gs)):
            if int(ks[i]) <= budget and (best is None or qs[i] > best[0]):
                best = (float(qs[i]), gs[i], labs[i], its[i])
        return best

    # -- SCU ---------------------------------------------------------------
    def secondary_user_labels(self, graph: BipartiteGraph, labels, wu, wv,
                              gamma: float) -> np.ndarray:
        """Secondary user clusters (Alg. 2 line 18): the runner-up label."""
        return self.resolve().secondary(graph, labels, wu, wv, gamma,
                                        device=self.device)

    # -- the paper's complete pipeline --------------------------------------
    def build(self, graph: BipartiteGraph, *, d: int = 64,
              budget: Optional[int] = None, ratio: float = 0.25,
              gamma: Optional[float] = None, scheme: str = "hws",
              max_iters: int = 8, scu: bool = True,
              batched_gamma: bool = False) -> Sketch:
        """Build the BACO sketch (budget handling, gamma auto-tuning,
        SCU, sketch assembly).

        budget: total codebook rows K_u + K_v; defaults to
        ratio*(|U|+|V|).
        """
        if budget is None:
            budget = max(2, int(round(ratio * graph.n_nodes)))
        eff_budget = budget
        if scu:  # Alg. 2: B' = (B*d - |U|) / d
            eff_budget = max(2, int((budget * d - graph.n_users) // d))
        wu, wv = make_weights(graph, scheme)
        if gamma is None:
            gamma, labels, iters = self.fit_gamma(graph, wu, wv, eff_budget,
                                                  max_iters=max_iters,
                                                  batched=batched_gamma)
        else:
            labels, iters = self.solve(graph, wu, wv, gamma, eff_budget,
                                       max_iters)
        pu = labels[:graph.n_users]
        pv = labels[graph.n_users:]
        meta = {"gamma": float(gamma), "iters": int(iters),
                "scheme": scheme, "solver": self.resolve().name,
                "budget": int(budget), "eff_budget": int(eff_budget),
                "scu": bool(scu),
                "joint_labels": np.asarray(labels, dtype=np.int32)}
        if scu:
            su = self.secondary_user_labels(graph, labels, wu, wv, gamma)
            meta["secondary_labels"] = np.asarray(su, dtype=np.int32)
            ku, pu_c, su_c = compact_labels(pu, su)
            kv, pv_c = compact_labels(pv)
            return Sketch(np.stack([pu_c, su_c], axis=1), pv_c[:, None],
                          ku, kv, method="baco", meta=meta)
        ku, pu_c = compact_labels(pu)
        kv, pv_c = compact_labels(pv)
        return Sketch(pu_c[:, None], pv_c[:, None], ku, kv,
                      method="baco(w/o scu)", meta=meta)

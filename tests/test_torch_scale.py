"""The port's scale pieces against the JAX package: node-aligned block
bounds, the streamed edge-block solve (bitwise the in-memory solve and
the reference's ``lp_solve_streamed`` at every block size, budget and
warm start, its ``stats`` keys, its spans), the host-loop and numpy
solvers, the engine's registry, ``solve_grid`` and ``block_edges``, and
the scale CLI. Everything runs on the CPU on small planted graphs built
from the same seed in both packages.

Run as a script, the file prints ``SCALE_REFERENCE`` for
``chip_smoke.py``: the reference's in-memory solve of the scale
ladder's 100k and 1M rungs on the CPU (labels digest, iterations,
modularity):

    PYTHONPATH=src python tests/test_torch_scale.py [rung ...]
"""
import hashlib
import json
import sys

import numpy as np
import pytest

from repro.core import ClusterEngine as JaxEngine
from repro.core import make_weights as jax_make_weights
from repro.core import node_aligned_bounds as jax_bounds
from repro.core import solver_jax
from repro.core import solver_numpy as jax_solver_numpy
from repro.core.engine import _secondary_numpy as jax_secondary_numpy
from repro.core.metrics import bipartite_modularity as jax_modularity
from repro.data import planted_coclusters as jax_planted
from repro.obs import trace as jax_trace

from repro_torch.core import (ClusterEngine, available_solvers, get_solver,
                              make_weights, node_aligned_bounds,
                              normalize_solver, solver_torch)
from repro_torch.core.metrics import bipartite_modularity
from repro_torch.data import planted_coclusters
from repro_torch.launch import cluster_scale
from repro_torch.obs import trace as port_trace


def pair(seed=0, nu=300, nv=90, k=8, deg=6):
    gj, _, _ = jax_planted(nu, nv, k, deg, seed=seed)
    gt, _, _ = planted_coclusters(nu, nv, k, deg, seed=seed)
    wu, wv = jax_make_weights(gj, "hws")
    return gj, gt, wu, wv


@pytest.fixture(scope="module")
def small():
    return pair()


# ---------------------------------------------------------------------------
# block bounds
# ---------------------------------------------------------------------------
def test_node_aligned_bounds_invariants_and_reference(small):
    gj, gt, _, _ = small
    for side in ("user", "item"):
        indptr = (gt.user_csr() if side == "user" else gt.item_csr())[0]
        deg = np.diff(indptr)
        for be in (1, 3, 16, 100, gt.n_edges, 10 * gt.n_edges):
            b = node_aligned_bounds(indptr, be)
            assert b[0] == 0 and b[-1] == gt.n_edges
            assert np.all(np.diff(b) > 0)
            assert np.all(np.isin(b, indptr))       # on node boundaries
            widths = np.diff(b)
            assert np.all((widths <= be) | (widths <= deg.max()))
            np.testing.assert_array_equal(b, jax_bounds(indptr, be))
            np.testing.assert_array_equal(gt.edge_block_bounds(side, be),
                                          gj.edge_block_bounds(side, be))
    assert gt.edge_block_bounds("user", 16) is gt.edge_block_bounds("user",
                                                                    16)
    with pytest.raises(ValueError):
        gt.edge_block_bounds("both", 16)
    with pytest.raises(ValueError):
        node_aligned_bounds(gt.user_csr()[0], 0)
    b = node_aligned_bounds(np.zeros(5, np.int64), 4)
    assert b[0] == 0 and b[-1] == 0
    np.testing.assert_array_equal(gt.biadjacency(), gj.biadjacency())


# ---------------------------------------------------------------------------
# the streamed solve
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("block", ["1", "7", "64", "1000", "E", "10E"])
def test_streamed_bitwise_at_every_block_size(small, block):
    gj, gt, wu, wv = small
    be = {"E": gt.n_edges, "10E": 10 * gt.n_edges}.get(block)
    be = int(block) if be is None else be
    for gamma in (0.0, 0.7):
        want, it_want = solver_torch.lp_solve(gt, wu, wv, gamma, max_iters=8,
                                              device="cpu")
        ref, it_ref = solver_jax.lp_solve_streamed(gj, wu, wv, gamma,
                                                   max_iters=8,
                                                   block_edges=be)
        got, it = solver_torch.lp_solve_streamed(gt, wu, wv, gamma,
                                                 max_iters=8, block_edges=be,
                                                 device="cpu")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, ref)
        assert it == it_want == it_ref
        assert got.dtype == np.int32


def test_streamed_budget_and_warm_start_parity():
    gj, gt, wu, wv = pair(seed=3)
    ref, it_ref = solver_jax.lp_solve_streamed(gj, wu, wv, 0.7, budget=40,
                                               max_iters=8, block_edges=50)
    lab, it = solver_torch.lp_solve_streamed(gt, wu, wv, 0.7, budget=40,
                                             max_iters=8, block_edges=50,
                                             device="cpu")
    assert it == it_ref and np.array_equal(lab, ref)
    init = np.arange(gt.n_nodes, dtype=np.int32)
    init[: gt.n_users // 2] = 0
    ref, it_ref = solver_jax.lp_solve(gj, wu, wv, 0.4, max_iters=6,
                                      init_labels=init)
    lab, it = solver_torch.lp_solve_streamed(gt, wu, wv, 0.4, max_iters=6,
                                             init_labels=init,
                                             block_edges=64, device="cpu")
    assert it == it_ref and np.array_equal(lab, ref)


def test_streamed_stats_keys_and_residency():
    gj, gt, wu, wv = pair()          # a graph no in-memory solve touched
    want, got = {}, {}
    solver_jax.lp_solve_streamed(gj, wu, wv, 0.7, max_iters=8,
                                 block_edges=100, stats=want)
    solver_torch.lp_solve_streamed(gt, wu, wv, 0.7, max_iters=8,
                                   block_edges=100, device="cpu", stats=got)
    assert set(got) == set(want)
    for k in ("n_blocks_user", "n_blocks_item", "block_pad_user",
              "block_pad_item", "block_edges", "sweeps"):
        assert got[k] == want[k], k
    assert got["sweeps"] == len(got["sweep_s"])
    assert got["blocks_per_s"] > 0 and got["peak_device_bytes"] > 0
    assert got["peak_bytes_source"] == "residency_estimate"
    # the plan is memoized under the reference's key; the in-memory
    # solver's device edge lists never are
    assert "stream_plan/100" in gt._cache
    assert not any(isinstance(k, tuple) and k[0] == "torch_edges"
                   for k in gt._cache)


def test_streamed_10k_rung_equals_reference():
    g, _ = cluster_scale.build_rung("10k")
    gj, _, _ = jax_planted(*cluster_scale.RUNGS["10k"][:2],
                           k_true=cluster_scale.RUNGS["10k"][2],
                           avg_deg=cluster_scale.AVG_DEG, seed=0)
    wu, wv = make_weights(g, "hws")
    want, it_want = solver_jax.lp_solve(gj, wu, wv, cluster_scale.GAMMA,
                                        max_iters=cluster_scale.MAX_ITERS)
    got, it, stats, _ = cluster_scale.solve_streamed(g, wu, wv, 1 << 12,
                                                     "cpu")
    np.testing.assert_array_equal(got, want)
    assert it == it_want and stats["n_blocks_user"] > 1


# ---------------------------------------------------------------------------
# the host-loop and numpy solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget", [None, 135])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 16.0])
def test_hostloop_equals_reference(small, gamma, budget):
    gj, gt, wu, wv = small
    want, it_want = solver_jax.lp_solve_hostloop(gj, wu, wv, gamma, budget)
    stats = {}
    got, it = solver_torch.lp_solve_hostloop(gt, wu, wv, gamma, budget,
                                             device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert it == it_want and stats["sweeps"] == it
    # the in-memory labels are the same; only the loop differs
    inmem, _ = solver_torch.lp_solve(gt, wu, wv, gamma, budget, max_iters=it,
                                     device="cpu")
    np.testing.assert_array_equal(got, inmem)


@pytest.mark.parametrize("budget", [None, 135])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 16.0])
def test_numpy_solver_equals_reference(small, gamma, budget):
    gj, gt, wu, wv = small
    want, it_want = jax_solver_numpy.lp_solve_sequential(gj, wu, wv, gamma,
                                                         budget)
    got, it = ClusterEngine(solver="numpy", device="cpu").solve(
        gt, wu, wv, gamma, budget)
    np.testing.assert_array_equal(got, want)
    assert it == it_want


def test_numpy_secondary_and_build_equal_reference(small):
    gj, gt, wu, wv = small
    lab, _ = jax_solver_numpy.lp_solve_sequential(gj, wu, wv, 1.0)
    np.testing.assert_array_equal(
        get_solver("numpy").secondary(gt, lab, wu, wv, 1.0, device="cpu"),
        jax_secondary_numpy(gj, lab, wu, wv, 1.0))
    want = JaxEngine(solver="numpy").build(gj, d=16, gamma=1.0)
    got = ClusterEngine(solver="numpy", device="cpu").build(gt, d=16,
                                                            gamma=1.0)
    np.testing.assert_array_equal(got.user_idx, want.user_idx)
    np.testing.assert_array_equal(got.item_idx, want.item_idx)
    assert got.meta["solver"] == "numpy"


# ---------------------------------------------------------------------------
# the engine's registry, solve_grid and block_edges
# ---------------------------------------------------------------------------
def test_registry_and_normalize_solver():
    assert available_solvers() == ("numpy", "torch", "torch_hostloop",
                                   "torch_streamed")
    assert normalize_solver(None) is None and normalize_solver("auto") is None
    assert normalize_solver("torch_streamed") == "torch_streamed"
    with pytest.raises(KeyError, match="torch_streamed"):
        normalize_solver("jax_streamed")
    assert ClusterEngine(device="cpu").resolve().name == "torch"
    assert [n for n in available_solvers()
            if get_solver(n).auto_eligible] == ["torch"]
    assert get_solver("torch_streamed").accepts_block_edges
    with pytest.raises(ValueError):
        ClusterEngine(block_edges=0, device="cpu")
    with pytest.raises(ValueError):
        ClusterEngine(block_edges=-4, device="cpu")
    ClusterEngine(candidates="minhash", block_edges=4, device="cpu")


def test_engine_streamed_block_edges_and_last_stats(small):
    gj, gt, wu, wv = small
    ref, _ = JaxEngine(solver="jax").solve(gj, wu, wv, 0.7, max_iters=8)
    eng = ClusterEngine(solver="torch_streamed", block_edges=500,
                        device="cpu")
    lab, it = eng.solve(gt, wu, wv, 0.7, max_iters=8)
    np.testing.assert_array_equal(lab, ref)
    assert eng.resolve().last_stats["block_edges"] == 500
    assert eng.stats["sweeps"] == it


@pytest.mark.parametrize("solver", ["torch", "torch_streamed"])
def test_solve_grid_equals_reference(small, solver):
    gj, gt, wu, wv = small
    gammas = [4.0, 1.0, 0.25]
    seed, _ = solver_jax.lp_solve(gj, wu, wv, 16.0, max_iters=2)
    want_l, want_i = JaxEngine(solver="jax").solve_grid(
        gj, wu, wv, gammas, 60, 8, init_labels=seed)
    got_l, got_i = ClusterEngine(solver=solver, device="cpu").solve_grid(
        gt, wu, wv, gammas, 60, 8, init_labels=seed)
    np.testing.assert_array_equal(got_l, want_l)
    np.testing.assert_array_equal(got_i, want_i)


def _span_tree(spans):
    by_id = {s.span_id: s.name for s in spans}
    return sorted({(s.name, by_id.get(s.parent_id), tuple(sorted(s.attrs)))
                   for s in spans})


def test_streamed_and_grid_spans_match_reference(small):
    gj, gt, wu, wv = small
    trees = []
    # the reference's streamed solver cannot solve_grid (its solve_many
    # takes no block_edges), so the grid runs on the in-memory solvers
    for mod, eng, grid, g in (
            (port_trace, ClusterEngine(solver="torch_streamed",
                                       block_edges=200, device="cpu"),
             ClusterEngine(solver="torch", device="cpu"), gt),
            (jax_trace, JaxEngine(solver="jax_streamed", block_edges=200),
             JaxEngine(solver="jax"), gj)):
        tr = (port_trace.Tracer(enabled=True) if mod is port_trace
              else jax_trace.Tracer(enabled=True, device_annotations=False))
        prev = mod.get_tracer()
        mod.set_tracer(tr)
        try:
            eng.solve(g, wu, wv, 0.7, max_iters=2)
            grid.solve_grid(g, wu, wv, [1.0, 0.5], max_iters=1)
        finally:
            mod.set_tracer(prev)
        trees.append(_span_tree(tr.spans()))
    assert trees[0] == trees[1]
    names = {(n, p) for n, p, _ in trees[0]}
    assert names == {("cluster_solve", None), ("lp_sweep", "cluster_solve"),
                     ("edge_block", "lp_sweep"), ("cluster_solve_grid", None)}


# ---------------------------------------------------------------------------
# the scale CLI and the pins chip_smoke.py holds
# ---------------------------------------------------------------------------
def test_scale_constants_are_the_reference_bench():
    from benchmarks import cluster_scale_bench as ref
    for name in ("RUNGS", "AVG_DEG", "GAMMA", "MAX_ITERS", "INMEM_MAX_EDGES",
                 "COLD_FRAC"):
        assert getattr(cluster_scale, name) == getattr(ref, name), name


def test_scale_cli_10k_record(tmp_path, capsys):
    out = tmp_path / "scale.json"
    assert cluster_scale.main(["--device", "cpu", "--rungs", "10k",
                               "--block-edges", "4096", "--json",
                               "--out", str(out)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    (r,) = rec["rungs"]
    assert r["bitwise_equal_inmem"] and r["sweeps"] >= 1
    assert r["modularity"] == r["modularity_inmem"]
    assert r["peak_bytes_source"] == "residency_estimate"
    assert set(r["cold"]) == {
        "n_cold_users", "n_labels", "exact_ms", "cand_ms",
        "minhash_total_ms", "cand_us_per_node", "minhash_recall",
        "agree_frac", "mean_candidates", "cand_frac_of_labels",
        "max_candidates", "mean_cold_degree"}
    assert r["cold"]["minhash_recall"] >= 0.95
    with pytest.raises(SystemExit):
        cluster_scale.main(["--device", "cpu", "--rungs", "2m"])


def labels_digest(labels) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        labels, dtype=np.int32).tobytes()).hexdigest()[:32]


def reference_scale_pin(rung: str) -> dict:
    """The reference's in-memory solve of one rung on the CPU (the
    graph from the JAX package's generator): labels digest, iterations
    and Barber modularity."""
    nu, nv, k = cluster_scale.RUNGS[rung]
    g, _, _ = jax_planted(nu, nv, k_true=k, avg_deg=cluster_scale.AVG_DEG,
                          seed=0)
    wu, wv = jax_make_weights(g, "hws")
    labels, iters = solver_jax.lp_solve(g, wu, wv, cluster_scale.GAMMA,
                                        max_iters=cluster_scale.MAX_ITERS)
    return {"n_edges": int(g.n_edges), "labels": labels_digest(labels),
            "iters": int(iters), "modularity": jax_modularity(g, labels)}


def test_scale_pin_of_the_10k_rung_matches_the_port():
    pin = reference_scale_pin("10k")
    g, _ = cluster_scale.build_rung("10k")
    wu, wv = make_weights(g, "hws")
    labels, iters, _, _ = cluster_scale.solve_inmem(g, wu, wv, "cpu")
    assert {"n_edges": g.n_edges, "labels": labels_digest(labels),
            "iters": iters,
            "modularity": bipartite_modularity(g, labels)} == pin


if __name__ == "__main__":
    rungs = sys.argv[1:] or ["100k", "1m"]
    print("SCALE_REFERENCE = " + json.dumps(
        {r: reference_scale_pin(r) for r in rungs}, indent=4))

"""The port's LP solver and ClusterEngine against the JAX package.

Same graph (the numpy generator is copied, so the same seed gives the
same edges), same weights; the port runs on the CPU. Labels, iteration
counts, selected gammas and sketches must be EQUAL: the port keeps the
reference's f32 arithmetic (one-rounding FMA score, ordered weight sums).
"""
import numpy as np
import pytest

from repro.core import ClusterEngine as JaxEngine
from repro.core import make_weights as jax_make_weights
from repro.core import solver_jax
from repro.data import planted_coclusters as jax_planted

from repro_torch.core import ClusterEngine, make_weights, solver_torch
from repro_torch.data import planted_coclusters

# ~3k and ~18k nodes
SIZES = {"3k": (1200, 1800, 24, 10), "18k": (8000, 10000, 80, 6)}


@pytest.fixture(scope="module", params=sorted(SIZES))
def graphs(request):
    nu, ni, k, deg = SIZES[request.param]
    gj, _, _ = jax_planted(nu, ni, k, deg, seed=0)
    gt, _, _ = planted_coclusters(nu, ni, k, deg, seed=0)
    return gj, gt


@pytest.fixture(scope="module")
def jax_builds():
    """The reference's sketches, built once per (graph, options)."""
    cache = {}

    def build(gj, **kw):
        key = (gj.n_nodes, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = JaxEngine(solver="jax").build(gj, d=16, ratio=0.25,
                                                       **kw)
        return cache[key]
    return build


def test_generator_and_weights_are_copies(graphs):
    gj, gt = graphs
    for name in ("edge_u", "edge_v", "perm_by_item"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))
    for a, b in zip(make_weights(gt, "hws"), jax_make_weights(gj, "hws")):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("gamma", [0.0625, 1.0, 16.0])
def test_lp_solve_labels_and_iters_equal(graphs, gamma):
    gj, gt = graphs
    wu, wv = jax_make_weights(gj, "hws")
    want, it_want = solver_jax.lp_solve(gj, wu, wv, gamma, max_iters=8)
    stats = {}
    got, it_got = solver_torch.lp_solve(gt, wu, wv, gamma, max_iters=8,
                                        device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert it_got == it_want
    assert stats["sweeps"] == it_got
    # one (K, converged) read per sweep + two ordered sums per sweep +
    # the final labels
    assert stats["host_syncs"] == 3 * it_got + 1


def test_lp_solve_grid_equal_with_seeds_and_budget(graphs):
    gj, gt = graphs
    wu, wv = jax_make_weights(gj, "hws")
    # four lanes: the lane count of fit_gamma's batched blocks, so the
    # reference compiles one grid program for this test and the build
    gammas = [4.0, 1.0, 0.25, 0.0625]
    seed, _ = solver_jax.lp_solve(gj, wu, wv, 16.0, max_iters=2)
    budget = gj.n_nodes // 6
    per_lane = np.stack([seed, np.arange(gj.n_nodes), seed, seed])
    for init in (None, per_lane):
        want_l, want_i = solver_jax.lp_solve_grid(gj, wu, wv, gammas, budget,
                                                  8, init_labels=init)
        got_l, got_i = solver_torch.lp_solve_grid(gt, wu, wv, gammas, budget,
                                                  8, init_labels=init,
                                                  device="cpu")
        np.testing.assert_array_equal(got_l, want_l)
        np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("kw", [dict(), dict(scu=False),
                                dict(batched_gamma=True)],
                         ids=["scu", "no_scu", "batched"])
def test_build_equal(graphs, jax_builds, kw):
    gj, gt = graphs
    ref_kw = dict(kw)
    if gj.n_nodes > 10_000:
        # the reference's batched walk equals its sequential walk bit for
        # bit (tests/test_cluster_engine.py pins it); at 18k nodes the
        # port's batched walk is held against the sequential build, which
        # saves compiling the reference's 18k-node lane programs
        ref_kw.pop("batched_gamma", None)
    want = jax_builds(gj, **ref_kw)
    got = ClusterEngine(device="cpu").build(gt, d=16, ratio=0.25, **kw)
    np.testing.assert_array_equal(got.user_idx, want.user_idx)
    np.testing.assert_array_equal(got.item_idx, want.item_idx)
    assert (got.k_users, got.k_items) == (want.k_users, want.k_items)
    for key in ("gamma", "iters", "budget", "eff_budget", "scu"):
        assert got.meta[key] == want.meta[key], key
    np.testing.assert_array_equal(got.meta["joint_labels"],
                                  want.meta["joint_labels"])


def test_engine_auto_solver_and_stats():
    g, _, _ = planted_coclusters(300, 200, 8, 6, seed=1)
    eng = ClusterEngine(device="cpu")
    assert eng.resolve().name == "torch"
    wu, wv = make_weights(g, "hws")
    _, it = eng.solve(g, wu, wv, 1.0)
    assert eng.stats["sweeps"] == it
    with pytest.raises(KeyError):
        ClusterEngine(solver="jax", device="cpu").resolve()

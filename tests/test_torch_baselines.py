"""The port's ETC baseline zoo and parameter accounting against the JAX
package: every ``BASELINES`` entry gives the reference's sketch for the
same graph and seed, ``build_sketch``'s kwarg guard raises the
reference's ``TypeError``, the sketch's dense views and ``one_hot``
match, ``baco_build`` is ``ClusterEngine.build``, an artifact's
``n_params()``/``serving_nbytes()`` equal the reference's for the same
trained state (fp32 and int8), and the train CLI trains a baseline.

``scc`` and ``sbc`` call ``scipy.sparse.linalg.svds`` without a start
vector, so each test first asks whether two reference calls agree: where
they do, the port is held bitwise; where they do not, it is held to what
the reference holds itself to (a valid sketch with the same K).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.core import BASELINES as JAX_BASELINES
from repro.core import Sketch as JaxSketch
from repro.core import baco_build as jax_baco_build
from repro.core import build_sketch as jax_build_sketch
from repro.data import planted_coclusters as jax_planted
from repro.serve import CompressedArtifact as JaxArtifact

from repro_torch.core import (BASELINES, ClusterEngine, Sketch, baco_build,
                              build_sketch, fit_gamma, make_weights,
                              secondary_user_labels)
from repro_torch.data import planted_coclusters, synthetic_bipartite
from repro_torch.serve import CompressedArtifact
from repro_torch.training import TrainConfig, Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
BUDGET = 100
UNSEEDED_SVDS = ("scc", "sbc")


def small_graphs(seed=7, nu=200, nv=150, k=8):
    gj, _, _ = jax_planted(nu, nv, k_true=k, avg_deg=10, seed=seed)
    gt, _, _ = planted_coclusters(nu, nv, k_true=k, avg_deg=10, seed=seed)
    return gj, gt


@pytest.fixture(scope="module")
def graphs():
    return small_graphs()


def same_sketch(a, b) -> bool:
    return (np.array_equal(a.user_idx, b.user_idx)
            and np.array_equal(a.item_idx, b.item_idx)
            and (a.k_users, a.k_items, a.method)
            == (b.k_users, b.k_items, b.method))


def test_registry_is_the_reference_zoo():
    assert list(BASELINES) == list(JAX_BASELINES)
    assert len(BASELINES) == 16


@pytest.mark.parametrize("name", list(JAX_BASELINES))
def test_baseline_sketch_equals_reference(graphs, name):
    gj, gt = graphs
    want = jax_build_sketch(name, gj, BUDGET, seed=0)
    got = build_sketch(name, gt, BUDGET, seed=0, device="cpu")
    assert isinstance(got, Sketch)
    if name in UNSEEDED_SVDS and not same_sketch(
            want, jax_build_sketch(name, gj, BUDGET, seed=0)):
        # the reference differs from itself: hold the port to a valid
        # sketch of the same size
        assert (got.k_users, got.k_items) == (want.k_users, want.k_items)
        assert got.user_idx.shape == want.user_idx.shape
        assert got.item_idx.shape == want.item_idx.shape
        return
    assert same_sketch(got, want), name
    for key in ("iters", "gamma", "levels"):
        if want.meta and key in want.meta:
            assert got.meta[key] == want.meta[key], key
    if want.meta and "joint_labels" in want.meta:
        np.testing.assert_array_equal(got.meta["joint_labels"],
                                      want.meta["joint_labels"])


@pytest.mark.parametrize("name,kw", [
    ("random", {"gamma": 1.0}), ("lp", {"gamm": 0.5}),
    ("lpab", {"max_iter": 3}), ("baco", {"ratio_": 0.3}),
    ("baco_no_scu", {"scu": True}), ("leiden", {"device": "cpu"}),
])
def test_kwarg_guard_raises_the_reference_error(graphs, name, kw):
    gj, gt = graphs
    with pytest.raises(TypeError) as want:
        jax_build_sketch(name, gj, BUDGET, **kw)
    if "device" in kw:                  # the port's own keyword
        build_sketch(name, gt, BUDGET, **kw)
        return
    with pytest.raises(TypeError) as got:
        build_sketch(name, gt, BUDGET, device="cpu", **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(KeyError):
        build_sketch("nope", gt, BUDGET)


def test_valid_kwargs_pass_through(graphs):
    gj, gt = graphs
    want = jax_build_sketch("lpab", gj, BUDGET, gamma=2.0, max_iters=3)
    got = build_sketch("lpab", gt, BUDGET, gamma=2.0, max_iters=3,
                       device="cpu")
    assert same_sketch(got, want) and got.meta["iters"] <= 3


def test_dense_views_and_one_hot(graphs):
    gj, gt = graphs
    for name in ("double", "baco", "lsh"):
        want = jax_build_sketch(name, gj, BUDGET)
        got = build_sketch(name, gt, BUDGET, device="cpu")
        np.testing.assert_array_equal(got.dense_Y_user(),
                                      want.dense_Y_user())
        np.testing.assert_array_equal(got.dense_Y_item(),
                                      want.dense_Y_item())
    rng = np.random.default_rng(0)
    ul, il = rng.integers(0, 40, 200) * 3, rng.integers(5, 30, 150)
    a = Sketch.one_hot(ul, il, method="x", meta={"k": 1})
    b = JaxSketch.one_hot(ul, il, method="x", meta={"k": 1})
    assert same_sketch(a, b) and a.meta == b.meta


def test_baco_wrappers_are_the_engine(graphs):
    gj, gt = graphs
    want = jax_baco_build(gj, d=16, budget=BUDGET)
    got = baco_build(gt, d=16, budget=BUDGET, device="cpu")
    eng = ClusterEngine(device="cpu").build(gt, d=16, budget=BUDGET)
    assert same_sketch(got, want) and same_sketch(got, eng)
    assert got.meta["solver"] == "torch" and got.meta["gamma"] == \
        want.meta["gamma"]
    wu, wv = make_weights(gt, "hws")
    g_fit, lab, it = fit_gamma(gt, wu, wv, 80, device="cpu")
    g_eng, lab_eng, it_eng = ClusterEngine(device="cpu").fit_gamma(
        gt, wu, wv, 80)
    assert g_fit == g_eng and it == it_eng
    np.testing.assert_array_equal(lab, lab_eng)
    np.testing.assert_array_equal(
        secondary_user_labels(gt, lab, wu, wv, g_fit, device="cpu"),
        ClusterEngine(device="cpu").secondary_user_labels(gt, lab, wu, wv,
                                                          g_fit))
    g = synthetic_bipartite(120, 90, 6, seed=2)
    from repro.data import synthetic_bipartite as jax_synthetic
    assert np.array_equal(g.edge_u, jax_synthetic(120, 90, 6, seed=2).edge_u)


@pytest.mark.parametrize("method", ["double", "lp", None])
def test_param_accounting_equals_reference(graphs, tmp_path, method):
    _, gt = graphs
    sketch = (None if method is None
              else build_sketch(method, gt, BUDGET, device="cpu"))
    tr = Trainer(gt, sketch, TrainConfig(dim=8, steps=3, batch_size=64,
                                         seed=0), device="cpu")
    tr.run(log_every=0)
    art = tr.export(str(tmp_path / "art"))
    ref = JaxArtifact.load(str(tmp_path / "art"))
    assert art.compressed == ref.compressed == (method is not None)
    for a, b in ((art, ref), (art.quantize(), ref.quantize()),
                 (art.quantize(keep_fp32=True),
                  ref.quantize(keep_fp32=True))):
        assert a.n_params() == b.n_params()
        assert a.serving_nbytes() == b.serving_nbytes()
    assert art.quantize().serving_nbytes() < art.serving_nbytes()
    if sketch is not None:
        assert art.n_params() == sketch.n_params(8)


def test_train_cli_trains_a_baseline(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--method", "double", "--dataset", "synth_xs", "--steps", "20",
         "--dim", "8", "--batch-size", "64", "--export",
         str(tmp_path / "art")],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "method=double" in out.stdout and "recall@20=" in out.stdout
    assert "sketch double:" in out.stdout
    art = CompressedArtifact.load(str(tmp_path / "art"))
    assert art.sketch.item_idx.shape[1] == 2 and art.compressed
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--cluster-solver", "jax_streamed"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert bad.returncode == 2 and "torch_streamed" in bad.stderr

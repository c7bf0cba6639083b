"""The port's LightGCN forward against the JAX package's.

Identical params (numpy, from a seed) and the same graph and sketch go
through ``repro.models.lightgcn`` and ``repro_torch.models.lightgcn`` on
the CPU. Tolerance rtol=1e-5, atol=1e-6: the reference reduces each
propagation segment with a tree prefix scan and a boundary difference,
the port folds it in edge order (the weighted CSR gather-sum's plain
version), so the sums add in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Sketch as JaxSketch
from repro.data import planted_coclusters as jax_planted
from repro.models import lightgcn as JL

from repro_torch.core import ClusterEngine
from repro_torch.data import planted_coclusters
from repro_torch.models import lightgcn as L

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    gj, _, _ = jax_planted(300, 240, 10, 8, seed=2)
    gt, _, _ = planted_coclusters(300, 240, 10, 8, seed=2)
    sk = ClusterEngine(device="cpu").build(gt, d=16, ratio=0.3)
    sk_j = JaxSketch(sk.user_idx, sk.item_idx, sk.k_users, sk.k_items,
                     method=sk.method)
    return gj, gt, sk, sk_j


def _both(setup, compressed, backend=None):
    gj, gt, sk, sk_j = setup
    cfg = L.from_sketch(gt, sk if compressed else None, dim=16, n_layers=3,
                        lookup_backend=backend)
    params = L.init_params(7, cfg)
    cfg_j = JL.from_sketch(gj, sk_j if compressed else None, dim=16,
                           n_layers=3)
    want = jax.jit(JL.all_embeddings, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in params.items()},
        JL.make_statics(gj, sk_j if compressed else None), cfg_j)
    statics = L.make_statics(gt, sk if compressed else None, device="cpu")
    got = L.all_embeddings({k: torch.as_tensor(v) for k, v in params.items()},
                           statics, cfg)
    return want, got, params, statics, cfg, cfg_j


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["full", "sketch"])
def test_all_embeddings_allclose(setup, compressed):
    want, got, *_ = _both(setup, compressed)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("compressed", [False, True],
                         ids=["full", "sketch"])
def test_eval_embeddings_and_scores_allclose(setup, compressed):
    gj, gt, sk, sk_j = setup
    _, _, params, statics, cfg, cfg_j = _both(setup, compressed)
    ids = np.array([0, 5, 17, 299, 5])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = JL.make_statics(gj, sk_j if compressed else None)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    wu, wv = jax.jit(JL.eval_embeddings, static_argnums=2)(
        jp, js, cfg_j, jnp.asarray(ids))
    gu, gv = L.eval_embeddings(tp, statics, cfg, torch.as_tensor(ids))
    np.testing.assert_allclose(gu.numpy(), np.asarray(wu), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=RTOL,
                               atol=ATOL)
    ws = jax.jit(JL.score_all_items, static_argnums=2)(
        jp, js, cfg_j, jnp.asarray(ids))
    gs = L.score_all_items(tp, statics, cfg, torch.as_tensor(ids))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=RTOL,
                               atol=ATOL)


def test_lookup_backends_give_identical_embeddings(setup):
    """The "cuda" backend (its plain version on the CPU) and "gather"
    build E0 identically, so the whole forward is bitwise equal."""
    outs = [_both(setup, True, backend=be)[1] for be in ("gather", "cuda")]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_statics_match_reference(setup):
    gj, gt, sk, sk_j = setup
    js = JL.make_statics(gj, sk_j)
    ts = L.make_statics(gt, sk, device="cpu")
    # the reference's keys, plus the kernel's int32 copies of two of them
    kernel_ids = {"edge_v_idx32": "edge_v",
                  "edge_u_byitem_idx32": "edge_u_byitem"}
    assert set(ts) == set(js) | set(kernel_ids)
    for key in js:
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    for key, of in kernel_ids.items():
        assert ts[key].dtype == torch.int32
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[of]))

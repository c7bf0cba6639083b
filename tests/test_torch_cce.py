"""The CCE baseline of the port (``training/cce.py``) against the JAX
package's (``repro.training.cce``), on the CPU.

A planted graph of 400 users and 300 items (d 16), 10% of its edges
held out as ``paperlike_dataset`` holds them out. Each package runs
``train_cce``; the port's two trainers start from the reference's own
initial tables (a fresh reference ``Trainer`` of the same sketch and
config: the port draws its tables from numpy, the reference from a
``jax.random`` key), and both sample the same numpy batches. Then:

  * the reclustered sketch (k-means on the expanded embeddings of the
    warm trainer) and its K equal the reference's bitwise: no k-means
    near-tie flips on this graph, so no metric tolerance stands in for
    the sketch;
  * Recall@20 and NDCG@20 after the second run within 0.005 (as the
    trainer test holds them), params equal;
  * ``_recluster`` copies the embeddings back once and calls the host
    k-means once per side.

``python tests/test_torch_cce.py`` prints the spread of the port's CPU
CCE at gowalla_s over seeds 0, 1 and 2 (48 steps after 16 warm steps,
``chip_smoke.CCE_CHECK``): the tolerance the smoke holds the card's
Recall@20 to against the CPU's.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import Sketch as JaxSketch  # noqa: E402
from repro.data import planted_coclusters as jax_planted  # noqa: E402
from repro.training import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training import Trainer as JaxTrainer  # noqa: E402
from repro.training import cce as jax_cce  # noqa: E402

from repro_torch.data import planted_coclusters  # noqa: E402
from repro_torch.training import Trainer, cce  # noqa: E402

KW = dict(dim=16, steps=24, warm_steps=12, batch_size=256, lr=5e-3, seed=0)


def _split(graph, cls, keep):
    return cls.from_edges(graph.n_users, graph.n_items, graph.edge_u[keep],
                          graph.edge_v[keep])


@pytest.fixture(scope="module")
def setup():
    """The planted graph and ``paperlike_dataset``'s 90/10 split: each
    edge kept with probability 0.9, each user's first edge always."""
    gt, _, _ = planted_coclusters(400, 300, 8, 8.0, seed=3)
    gj, _, _ = jax_planted(400, 300, 8, 8.0, seed=3)
    keep = np.random.default_rng(4).random(gt.n_edges) < 0.9
    keep[np.unique(gt.edge_u, return_index=True)[1]] = True
    test = (gt.edge_u[~keep], gt.edge_v[~keep])
    return (_split(gt, type(gt), keep), _split(gj, type(gj), keep), test)


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _from_reference(jgraph):
    """A port Trainer whose tables start as a fresh reference Trainer's
    of the same sketch and config."""
    class RefInit(Trainer):
        def __init__(self, graph, sketch, cfg, device="cuda"):
            super().__init__(graph, sketch, cfg, device=device)
            jsk = JaxSketch(sketch.user_idx, sketch.item_idx,
                            sketch.k_users, sketch.k_items)
            jt = JaxTrainer(jgraph, jsk, JaxTrainConfig(
                dim=cfg.dim, steps=cfg.steps, batch_size=cfg.batch_size,
                lr=cfg.lr, seed=cfg.seed))
            for k, v in jt.params.items():
                with torch.no_grad():
                    self.params[k].copy_(torch.as_tensor(np.array(v)))
    return RefInit


def test_train_cce_equals_the_reference(setup, one_thread, monkeypatch):
    gt, gj, test = setup
    budget = int(0.25 * gt.n_nodes)
    want_m, want_sk, want_tr = jax_cce.train_cce(gj, test, budget=budget,
                                                 **KW)
    monkeypatch.setattr(cce, "Trainer", _from_reference(gj))
    calls = []
    orig = cce._kmeans
    monkeypatch.setattr(cce, "_kmeans", lambda x, k, seed=0: (
        calls.append((x.shape, k, seed)) or orig(x, k, seed=seed)))
    got_m, got_sk, got_tr = cce.train_cce(gt, test, budget=budget,
                                          device="cpu", **KW)
    assert [c[1:] for c in calls] == [
        (cce.random_sketch(gt, budget).k_users, 0),
        (cce.random_sketch(gt, budget).k_items, 1)]
    assert calls[0][0] == (gt.n_users, 16) and calls[1][0] == (gt.n_items, 16)
    assert (got_sk.k_users, got_sk.k_items) == (want_sk.k_users,
                                                want_sk.k_items)
    np.testing.assert_array_equal(got_sk.user_idx, want_sk.user_idx)
    np.testing.assert_array_equal(got_sk.item_idx, want_sk.item_idx)
    assert got_sk.method == want_sk.method == "cce"
    assert got_m["params"] == want_m["params"] == got_tr.n_params()
    assert got_m["n_users"] == want_m["n_users"] > 0
    assert abs(got_m["recall"] - want_m["recall"]) <= 0.005
    assert abs(got_m["ndcg"] - want_m["ndcg"]) <= 0.005


def test_recluster_equals_the_reference_on_one_state(setup, one_thread):
    """``_recluster`` on one trained state (the reference's warm tables
    carried over): the same sketch as the reference's ``_recluster``."""
    gt, gj, _ = setup
    budget = int(0.25 * gt.n_nodes)
    sk0 = cce.random_sketch(gt, budget, seed=0)
    jsk = JaxSketch(sk0.user_idx, sk0.item_idx, sk0.k_users, sk0.k_items)
    cfg = dict(dim=16, steps=10, batch_size=256, lr=5e-3, seed=0)
    jt = JaxTrainer(gj, jsk, JaxTrainConfig(**cfg))
    jt.run(log_every=0)
    pt = _from_reference(gj)(gt, sk0, cce.TrainConfig(**cfg), device="cpu")
    with torch.no_grad():
        for k, v in jt.params.items():
            pt.params[k].copy_(torch.as_tensor(np.array(v)))
    want = jax_cce._recluster(jt, gj, sk0.k_users, sk0.k_items, seed=4)
    got = cce._recluster(pt, gt, sk0.k_users, sk0.k_items, seed=4)
    np.testing.assert_array_equal(got.user_idx, want.user_idx)
    np.testing.assert_array_equal(got.item_idx, want.item_idx)


def cpu_spread(dataset: str = "gowalla_s", seeds=(0, 1, 2)) -> dict:
    """The port's CPU CCE at ``dataset`` (budget 0.25 x nodes, the
    smoke's ``CCE_CHECK`` steps) for each seed: Recall@20 and K."""
    import sys
    sys.path.insert(0, ".")
    import chip_smoke
    from repro_torch.data import paperlike_dataset
    _, _, _, train, test = paperlike_dataset(dataset, seed=0)
    out = {}
    for s in seeds:
        m, sk, _ = cce.train_cce(train, test, budget=int(0.25 * train.n_nodes),
                                 seed=s, device="cpu", **chip_smoke.CCE_CHECK)
        out[s] = {"recall": m["recall"], "k": [sk.k_users, sk.k_items]}
    rec = [v["recall"] for v in out.values()]
    return {"runs": out, "spread": max(rec) - min(rec)}


if __name__ == "__main__":
    print(cpu_spread())

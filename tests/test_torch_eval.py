"""The port's evaluation against the JAX package's, on the CPU.

``topk_streaming`` on its three backends ("block", "hostloop", "fused")
against the reference's on the same numpy embeddings: ids identical on
exact-arithmetic data (small integer-valued embeddings, so every score
is exact in f32 and both packages rank the same numbers, ties included),
with exclusions, item counts that do not divide into the block, and
rows with fewer than k scoreable items (the fill semantics differ by
backend, and each matches its reference counterpart). The reference's
"fused" backend runs its Pallas kernel in interpret mode.
``recall_ndcg_at_k`` and ``topk_from_scores`` are copies and must give
identical results. ``Trainer.evaluate`` gives the same metrics through
every backend on the port's own trained tables.
"""
import numpy as np
import pytest
import torch

from repro.training import eval as jax_eval

from repro_torch.core import ClusterEngine
from repro_torch.data import planted_coclusters
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training import eval as E


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run thousands of tiny ops, and
    several test processes share the machine; idle OpenMP threads
    spinning between ops would slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(seed=0, m=37, n=301, d=8):
    rng = np.random.default_rng(seed)
    u = rng.integers(-3, 4, (m, d)).astype(np.float32)
    v = rng.integers(-3, 4, (n, d)).astype(np.float32)
    rows = rng.integers(0, m, 400).astype(np.int32)
    cols = rng.integers(0, n, 400).astype(np.int32)
    # row 5 keeps 3 scoreable items: fewer than k
    keep = np.array([11, 150, 299])
    rows = np.concatenate([rows, np.full(n - 3, 5, np.int32)])
    cols = np.concatenate([cols, np.setdiff1d(np.arange(n), keep)
                           .astype(np.int32)])
    return u, v, (rows, cols)


@pytest.mark.parametrize("backend", ["block", "hostloop", "fused"])
@pytest.mark.parametrize("block", [64, 128, 1000])
@pytest.mark.parametrize("excluded", [False, True])
def test_topk_streaming_matches_reference(backend, block, excluded):
    u, v, ex = _exact()
    ex = ex if excluded else None
    want = jax_eval.topk_streaming(u, v, 10, block=block, exclude=ex,
                                   backend=backend)
    got = E.topk_streaming(torch.as_tensor(u), torch.as_tensor(v), 10,
                           block=block, exclude=ex, backend=backend)
    assert got.dtype == np.int32 and got.shape == (u.shape[0], 10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_topk_streaming_refuses_bad_arguments():
    u, v, _ = _exact()
    with pytest.raises(ValueError):
        E.topk_streaming(torch.as_tensor(u), torch.as_tensor(v), 400)
    with pytest.raises(ValueError):
        E.topk_streaming(torch.as_tensor(u), torch.as_tensor(v), 5,
                         backend="scan")


def test_recall_ndcg_and_dense_topk_are_the_reference():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((40, 90)).astype(np.float32)
    ex = (rng.integers(0, 40, 100), rng.integers(0, 90, 100))
    topk = E.topk_from_scores(scores, 20, exclude=ex)
    np.testing.assert_array_equal(
        topk, jax_eval.topk_from_scores(scores, 20, exclude=ex))
    users = np.arange(40) * 2
    tu = rng.choice(users, 150)
    ti = rng.integers(0, 90, 150)
    assert E.recall_ndcg_at_k(topk, tu, ti, users, k=20) == \
        jax_eval.recall_ndcg_at_k(topk, tu, ti, users, k=20)
    assert E.recall_ndcg_at_k(topk, tu[:0], ti[:0], users) == \
        {"recall": 0.0, "ndcg": 0.0, "n_users": 0}


def test_evaluate_through_every_backend():
    g, _, _ = planted_coclusters(200, 150, 6, 8, seed=4)
    sk = ClusterEngine(device="cpu").build(g, d=8, ratio=0.3)
    tr = Trainer(g, sk, TrainConfig(dim=8, steps=10, batch_size=64, lr=1e-2),
                 device="cpu")
    tr.run(log_every=0)
    test = (np.arange(0, 200, 2), (np.arange(0, 200, 2) * 5) % 150)
    out = {b: tr.evaluate(test, item_block=64, topk_backend=b)
           for b in ("block", "hostloop", "fused")}
    assert out["block"] == out["hostloop"]
    assert out["block"]["n_users"] == 100
    for key in ("recall", "ndcg"):
        assert abs(out["fused"][key] - out["block"][key]) <= 1e-6

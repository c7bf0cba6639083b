"""The port's embedding layer against the JAX package's.

The same numpy inputs go through ``repro.embedding`` (Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU) and
through ``repro_torch.embedding`` on CPU tensors, where the kernel
wrappers run the plain versions the CUDA kernels are held against on the
card. Tolerances:

  * bitwise where the port adds in the reference's order: bag sums and
    means (each bag folded in value order from +0.0, as XLA's CPU
    ``segment_sum`` does), codebook and full lookups;
  * top-k ids exact and values exact on integer-valued inputs; on random
    floats values within rtol 1e-5 and ids equal up to near-ties within
    1e-5 relative (the dot products add in another order);
  * gradients rtol = atol = 1e-5, as in ``tests/test_engine.py``;
  * the one-hot backend (a matmul in each framework) rtol = atol = 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.embedding as JE
from repro.configs.lightgcn_baco import smoke_config
from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.fused_topk import fused_topk_codebook_pallas
from repro.models import lightgcn as JL

import repro_torch.embedding as TE
from repro_torch.embedding.engine import EmbeddingEngine as TEngine
from repro_torch.kernels import (csr_gather_sum, embedding_bag,
                                 fused_topk_codebook, platform, ref)
from repro_torch.kernels.fused_topk import _check_sketch
from repro_torch.models import lightgcn as L

GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _bags(seed, n=40, d=16, nnz=64, nseg=11, empty=(3, 7)):
    """table f32 [n, d], values int32 [nnz], sorted segment ids int32
    [nnz] that skip the ``empty`` bags."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    vals = rng.integers(0, n, nnz).astype(np.int32)
    live = np.setdiff1d(np.arange(nseg), empty)
    segs = np.sort(rng.choice(live, nnz)).astype(np.int32)
    return table, vals, segs


def _sketch(n, k, h, seed, dup_every=3):
    sk = np.random.default_rng(seed).integers(0, k, (n, h)).astype(np.int32)
    if h > 1:
        sk[::dup_every, h - 1] = sk[::dup_every, 0]     # SCU duplicates
    return sk


# ---------------------------------------------------------------------------
# bags: forward, dispatch rules
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_forward_bitwise_pallas(mode):
    table, vals, segs = _bags(0)
    nseg = 11
    pallas = np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(segs),
        num_segments=nseg, interpret=True))
    if mode == "sum":
        got = embedding_bag(_t(table), _t(vals), _t(segs), nseg).numpy()
        np.testing.assert_array_equal(got, pallas)
        assert not got[[3, 7]].any()                    # empty bags
    want = np.asarray(JE.EmbeddingEngine(
        JE.EmbeddingSpec(40, 16), backend="pallas").bag_lookup(
        jnp.asarray(table), jnp.asarray(vals), jnp.asarray(segs), nseg,
        mode=mode))
    for be in ("cuda", "gather"):
        got = TE.EmbeddingEngine(TE.EmbeddingSpec(40, 16), backend=be) \
            .bag_lookup(_t(table), _t(vals), _t(segs), nseg, mode=mode,
                        indices_sorted=True).numpy()
        np.testing.assert_array_equal(got, want)


def test_bag_single_value_and_all_empty():
    table = np.random.default_rng(1).standard_normal((9, 8)).astype(
        np.float32)
    vals = np.array([4, 2, 2], np.int32)
    segs = np.array([0, 2, 5], np.int32)               # one value per bag
    got = embedding_bag(_t(table), _t(vals), _t(segs), 6).numpy()
    np.testing.assert_array_equal(got[[0, 2, 5]], table[[4, 2, 2]])
    assert not got[[1, 3, 4]].any()
    empty = embedding_bag(_t(table), _t(vals[:0]), _t(segs[:0]), 4)
    assert empty.shape == (4, 8) and not empty.any()


def test_csr_gather_sum_is_the_bag_of_its_pointers():
    table, vals, segs = _bags(2)
    ptr = np.searchsorted(segs, np.arange(12)).astype(np.int64)
    got = csr_gather_sum(_t(table), _t(vals), _t(ptr)).numpy()
    want = np.asarray(JE.embedding_bag(jnp.asarray(table), jnp.asarray(vals),
                                       jnp.asarray(segs), 11))
    np.testing.assert_array_equal(got, want)


def test_bag_wrapper_refuses_what_the_kernel_does_not_take():
    t = torch.arange(20, dtype=torch.float32).reshape(5, 4)
    # unsorted segment ids are taken (sorted stably in the wrapper)
    vals, segs = np.array([0, 1, 4, 2], np.int32), np.array([1, 0, 1, 0])
    np.testing.assert_array_equal(
        embedding_bag(t, _t(vals), _t(segs), 2).numpy(),
        np.asarray(JE.embedding_bag(jnp.asarray(t.numpy()), jnp.asarray(vals),
                                    jnp.asarray(segs), 2)))
    with pytest.raises(ValueError, match="lie in"):
        embedding_bag(t, torch.tensor([0, 5]), torch.tensor([0, 1]), 2)
    with pytest.raises(ValueError, match="lie in"):
        embedding_bag(t, torch.tensor([0, 1]), torch.tensor([0, 2]), 2)
    with pytest.raises(TypeError):
        embedding_bag(t, torch.tensor([0.0, 1.0]), torch.tensor([0, 1]), 2)


@pytest.fixture
def cuda_bag_calls(monkeypatch):
    """Auto-selection resolves to "cuda" (as on a GPU); records each call
    of the cuda backend's bag."""
    cuda = TE.get_backend("cuda")
    calls = []
    real = type(cuda).bag

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)

    monkeypatch.setattr(type(cuda), "bag", spy)
    monkeypatch.setattr(TEngine, "resolve", lambda self, kind, dev: cuda)
    return calls


def test_bag_dispatch_rules(cuda_bag_calls):
    rng = np.random.default_rng(3)
    table = rng.standard_normal((12, 8)).astype(np.float32)
    vals = np.array([1, 2, 3, 7], np.int32)
    segs = np.array([0, 1, 0, 2], np.int32)            # NOT sorted
    w = rng.random(4).astype(np.float32)
    eng = TE.EmbeddingEngine(TE.EmbeddingSpec(12, 8))
    jeng = JE.EmbeddingEngine(JE.EmbeddingSpec(12, 8), backend="gather")
    # unsorted and undeclared: still the cuda backend (its wrapper sorts
    # the bags; the reference sends these to gather only because its
    # Pallas kernel cannot), with the reference's answer
    got = eng.bag_lookup(_t(table), _t(vals), _t(segs), 3).numpy()
    want = jeng.bag_lookup(jnp.asarray(table), jnp.asarray(vals),
                           jnp.asarray(segs), 3)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(cuda_bag_calls) == 1
    # weighted: gather even when declared sorted
    ss = np.sort(segs)
    got = eng.bag_lookup(_t(table), _t(vals), _t(ss), 3, weights=_t(w),
                         indices_sorted=True).numpy()
    want = jeng.bag_lookup(jnp.asarray(table), jnp.asarray(vals),
                           jnp.asarray(ss), 3, weights=jnp.asarray(w))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(cuda_bag_calls) == 1
    # sorted and declared: the cuda backend
    eng.bag_lookup(_t(table), _t(vals), _t(ss), 3, indices_sorted=True)
    assert len(cuda_bag_calls) == 2


def test_explicit_cuda_bag_is_honored_and_checks_order():
    eng = TE.EmbeddingEngine(TE.EmbeddingSpec(12, 8), backend="cuda")
    table = np.random.default_rng(22).standard_normal((12, 8)).astype(
        np.float32)
    vals, segs = np.array([1, 2, 5, 9, 1]), np.array([1, 0, 2, 1, 0])
    for mode in ("sum", "mean"):
        np.testing.assert_array_equal(
            eng.bag_lookup(_t(table), _t(vals), _t(segs), 4,
                           mode=mode).numpy(),
            np.asarray(JE.embedding_bag(jnp.asarray(table), jnp.asarray(vals),
                                        jnp.asarray(segs), 4, mode=mode)))
    with pytest.raises(NotImplementedError):
        TE.get_backend("cuda").bag(torch.zeros(12, 8), torch.tensor([1]),
                                   torch.tensor([0]), 1,
                                   weights=torch.ones(1))


def test_onehot_rejects_bag():
    eng = TE.EmbeddingEngine(TE.EmbeddingSpec(10, 8), backend="onehot")
    with pytest.raises(ValueError, match="does not support"):
        eng.bag_lookup(torch.ones(10, 8), torch.tensor([0]),
                       torch.tensor([0]), 2)


# ---------------------------------------------------------------------------
# full and codebook lookups, the registry, the legacy entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("backend", ["gather", "onehot", "cuda", None])
def test_full_kind(backend):
    rng = np.random.default_rng(4)
    table = rng.standard_normal((32, 16)).astype(np.float32)
    ids = rng.integers(0, 32, (4, 5)).astype(np.int32)
    want = np.asarray(JE.embedding_lookup(jnp.asarray(table),
                                          jnp.asarray(ids), backend="pallas"))
    got = TE.embedding_lookup(_t(table), _t(ids), backend=backend).numpy()
    assert got.shape == (4, 5, 16)
    if backend == "onehot":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [-1, 32, 2 ** 31])
def test_full_kind_refuses_ids_out_of_range(bad):
    table = torch.randn(32, 8)
    ids = torch.tensor([[0, 5], [bad, 31]], dtype=torch.int64)
    with pytest.raises(ValueError, match="lie in"):
        TE.embedding_lookup(table, ids, backend="cuda")


def test_sketch_range_is_checked_once_per_version(monkeypatch):
    calls = []
    real = torch.aminmax
    monkeypatch.setattr(torch, "aminmax",
                        lambda t: calls.append(1) or real(t))
    sk = torch.tensor([[0, 3], [2, 2]], dtype=torch.int32)
    for _ in range(3):
        _check_sketch(sk, 4)
    assert len(calls) == 1                     # a frozen sketch: one scan
    with pytest.raises(ValueError, match="lie in"):
        _check_sketch(sk, 3)                   # the cached largest entry
    assert len(calls) == 1
    sk[1, 0] = 7                               # an in-place write: rescan
    with pytest.raises(ValueError, match="lie in"):
        _check_sketch(sk, 4)
    sk[1, 0] = -1
    with pytest.raises(ValueError, match="lie in"):
        _check_sketch(sk, 8)
    assert len(calls) == 3
    _check_sketch(sk.clone().clamp_(min=0), 4)  # another tensor: its own scan
    assert len(calls) == 4


@pytest.mark.parametrize("backend", ["gather", "onehot", "cuda"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_codebook_kind_and_combine(backend, combine):
    rng = np.random.default_rng(5)
    cb = rng.standard_normal((24, 32)).astype(np.float32)
    sk = _sketch(50, 24, 2, seed=6)
    ids = rng.integers(0, 50, 17).astype(np.int32)
    want = np.asarray(JE.codebook_lookup(jnp.asarray(cb), jnp.asarray(sk),
                                         jnp.asarray(ids), combine=combine,
                                         via="pallas"))
    got = TE.codebook_lookup(_t(cb), _t(sk), _t(ids), combine=combine,
                             via=backend).numpy()
    if backend == "onehot":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_lookup_entry_and_registry():
    assert {"gather", "onehot", "cuda"} <= set(TE.available_backends())
    assert TE.available_scorers() == ("cuda",)
    cb = torch.randn(6, 4)
    sk = torch.tensor([[0, 0], [1, 5], [2, 3]], dtype=torch.int32)
    comp = TE.EmbeddingEngine(TE.EmbeddingSpec(3, 4, k_rows=6, n_hot=2))
    torch.testing.assert_close(comp.lookup(cb, torch.tensor([0, 1]), sk),
                               torch.stack([cb[0], cb[1] + cb[5]]),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no sketch"):
        comp.lookup(cb, torch.tensor([0]))
    full = TE.EmbeddingEngine(TE.EmbeddingSpec(6, 4))
    assert torch.equal(full.lookup(cb, torch.tensor([5])), cb[[5]])
    with pytest.raises(ValueError, match="combine"):
        comp.codebook_lookup(cb, sk, combine="max")
    with pytest.raises(KeyError):
        TE.get_backend("pallas")


def test_legacy_table_entry_points():
    rng = np.random.default_rng(8)
    t = TE.init_embedding(np.random.default_rng(0), 20, 8)
    assert t.dtype == np.float32 and t.shape == (20, 8)
    np.testing.assert_array_equal(
        TE.init_codebook(np.random.default_rng(0), 20, 8), t)
    ids = rng.integers(0, 20, 7).astype(np.int32)
    np.testing.assert_array_equal(
        TE.embed_lookup(_t(t), _t(ids)).numpy(),
        np.asarray(JE.embed_lookup(jnp.asarray(t), jnp.asarray(ids))))
    table, vals, segs = _bags(9, n=20, d=8)
    for mode in ("sum", "mean"):
        np.testing.assert_array_equal(
            TE.embedding_bag(_t(table), _t(vals), _t(segs), 11,
                             mode=mode).numpy(),
            np.asarray(JE.embedding_bag(jnp.asarray(table),
                                        jnp.asarray(vals),
                                        jnp.asarray(segs), 11, mode=mode)))


# ---------------------------------------------------------------------------
# the codebook fused top-k
# ---------------------------------------------------------------------------
def _codebook_pair(u, cb, sk, k, **kw):
    jkw = {key: (jnp.asarray(a) if key != "exclude" else a)
           for key, a in kw.items()}
    want = fused_topk_codebook_pallas(jnp.asarray(u), jnp.asarray(cb),
                                      jnp.asarray(sk), k, block=16,
                                      interpret=True, **jkw)
    tkw = {key: (_t(a) if key != "exclude" else tuple(map(_t, a)))
           for key, a in kw.items()}
    got = TE.fused_topk(_t(u), _t(cb), k, sketch=_t(sk), **tkw)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


def _own_scores(u, cb, sk, scale=None, mask=None, exclude=None):
    """(f64 [B, N] scores of the codebook readout, f64 [B, N] Σ|u·v|,
    which the f32 rounding of each dot product scales with), in numpy."""
    z = cb.astype(np.float64)
    if scale is not None:
        z = z * scale[:, None]
    v = np.zeros((sk.shape[0], z.shape[1]))
    for h in range(sk.shape[1]):
        keep = np.ones(sk.shape[0], bool)
        for j in range(h):
            keep &= sk[:, h] != sk[:, j]
        v += np.where(keep[:, None], z[sk[:, h]], 0.0)
    s = u.astype(np.float64) @ v.T
    size = np.abs(u.astype(np.float64)) @ np.abs(v).T
    if mask is not None:
        s = s + mask
    if exclude is not None:
        s[exclude[0], exclude[1]] = -np.inf
    return s, size


def _ids_agree_up_to_near_ties(want, got, own, rtol=1e-5):
    """Values within rtol, ids equal up to near-ties, and every id of
    either list scores the value returned with it (``own`` from
    ``_own_scores``), so a differing id cannot be a wrong item."""
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=1e-6)
    diff = got[1] != want[1]
    assert diff.mean() < 0.05
    np.testing.assert_allclose(got[0][diff], want[0][diff], rtol=rtol)
    scores, size = own
    rows = np.arange(got[1].shape[0])[:, None]
    for vals, ids in (want, got):
        s, tol = scores[rows, ids], 1e-6 + rtol * size[rows, ids]
        fin = np.isfinite(s)
        assert np.array_equal(np.isfinite(vals), fin)
        assert (np.abs(vals[fin] - s[fin]) <= tol[fin]).all()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("extras", ["none", "mask+exclude"])
def test_fused_topk_codebook_matches_pallas(quant, extras):
    rng = np.random.default_rng(10)
    n, kk, d = 70, 13, 8
    sk = _sketch(n, kk, 2, seed=11)
    u = rng.integers(-2, 3, (5, d)).astype(np.float32)
    cb = rng.integers(-2, 3, (kk, d)).astype(np.float32)
    kw = {}
    if quant:
        cb = rng.integers(-127, 128, (kk, d)).astype(np.int8)
        kw["scale"] = (2.0 ** rng.integers(-3, 2, kk)).astype(np.float32)
    if extras != "none":
        mask = np.zeros(n, np.float32)
        mask[rng.choice(n, 20, replace=False)] = -np.inf
        rows = rng.integers(0, 5, 30).astype(np.int32)
        cols = rng.integers(0, n, 30).astype(np.int32)
        kw.update(mask=mask, exclude=(rows, cols))
    # integer-valued scores: exact (ties everywhere: the tie order)
    want, got = _codebook_pair(u, cb, sk, 9, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    # random floats
    uf = rng.standard_normal((5, d)).astype(np.float32)
    if quant:
        kw["scale"] = (rng.random(kk) * 0.02 + 1e-3).astype(np.float32)
    else:
        cb = rng.standard_normal((kk, d)).astype(np.float32)
    want, got = _codebook_pair(uf, cb, sk, 9, **kw)
    _ids_agree_up_to_near_ties(want, got, _own_scores(uf, cb, sk, **kw))


def test_fused_topk_codebook_h1_and_ragged_chunk():
    rng = np.random.default_rng(12)
    sk = _sketch(37, 9, 1, seed=13)
    u = rng.integers(-2, 3, (3, 8)).astype(np.float32)
    cb = rng.integers(-2, 3, (9, 8)).astype(np.float32)
    want, got = _codebook_pair(u, cb, sk, 6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match="exceeds"):
        fused_topk_codebook(_t(u), _t(cb), _t(sk), 38)


def test_topk_nan_order_is_lax_top_k():
    s = np.array([[1.0, np.nan, 3.0, np.nan, -np.inf, 2.0, np.inf, 3.0],
                  [np.nan] * 8,
                  [-np.inf, np.nan, -np.inf, 5.0, 5.0, np.nan, 0.5, 1.0]],
                 np.float32)
    for k in (1, 4, 8):
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_v, got_i = ref.topk(_t(s), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ---------------------------------------------------------------------------
# gradients: the port's autograd through backend="cuda" (plain versions on
# the CPU) against jax.grad through backend="pallas"
# ---------------------------------------------------------------------------
def _grads(jax_loss, torch_loss, x):
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = _t(x).clone().requires_grad_(True)
    (got,) = torch.autograd.grad(torch_loss(xt), xt)
    return got.numpy(), want


@pytest.mark.parametrize("h", [1, 2])
def test_codebook_lookup_grad(h):
    rng = np.random.default_rng(14)
    k, d, n, b = 12, 8, 30, 19
    cb = rng.standard_normal((k, d)).astype(np.float32)
    sk = _sketch(n, k, h, seed=15, dup_every=4)
    ids = rng.integers(0, n, b).astype(np.int32)
    tgt = rng.standard_normal((b, d)).astype(np.float32)
    jspec = JE.EmbeddingSpec(n, d, k_rows=k, n_hot=h)
    tspec = TE.EmbeddingSpec(n, d, k_rows=k, n_hot=h)

    def jl(c):
        out = JE.EmbeddingEngine(jspec, backend="pallas").codebook_lookup(
            c, jnp.asarray(sk), jnp.asarray(ids))
        return jnp.sum((out - tgt) ** 2)

    def tl(c):
        out = TE.EmbeddingEngine(tspec, backend="cuda").codebook_lookup(
            c, _t(sk), _t(ids))
        return torch.sum((out - _t(tgt)) ** 2)

    got, want = _grads(jl, tl, cb)
    np.testing.assert_allclose(got, want, **GRAD_TOL)


@pytest.mark.parametrize("order", ["sorted", "unsorted"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_lookup_grad(mode, order):
    table, vals, segs = _bags(16, n=20, d=8, nnz=40, nseg=9, empty=(4,))
    w = np.random.default_rng(17).standard_normal((9, 8)).astype(np.float32)
    jbackend = "pallas"
    if order == "unsorted":          # the Pallas kernel takes sorted bags
        perm = np.random.default_rng(23).permutation(vals.size)
        vals, segs, jbackend = vals[perm], segs[perm], "gather"

    def jl(t):
        out = JE.EmbeddingEngine(JE.EmbeddingSpec(20, 8),
                                 backend=jbackend).bag_lookup(
            t, jnp.asarray(vals), jnp.asarray(segs), 9, mode=mode)
        return jnp.sum(out * w) + jnp.sum(out ** 2)

    def tl(t):
        out = TE.EmbeddingEngine(TE.EmbeddingSpec(20, 8),
                                 backend="cuda").bag_lookup(
            t, _t(vals), _t(segs), 9, mode=mode)
        return torch.sum(out * _t(w)) + torch.sum(out ** 2)

    got, want = _grads(jl, tl, table)
    np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_full_lookup_grad():
    rng = np.random.default_rng(18)
    table = rng.standard_normal((16, 8)).astype(np.float32)
    ids = rng.integers(0, 16, (3, 7)).astype(np.int32)      # repeats
    w = rng.standard_normal((3, 7, 8)).astype(np.float32)

    def jl(t):
        return jnp.sum(JE.embedding_lookup(t, jnp.asarray(ids),
                                           backend="pallas") * w)

    def tl(t):
        return torch.sum(TE.embedding_lookup(t, _t(ids), backend="cuda")
                         * _t(w))

    got, want = _grads(jl, tl, table)
    np.testing.assert_allclose(got, want, **GRAD_TOL)


def test_base_embeddings_grad_whole_slice():
    """The slice as a whole: d/dZ of a weighted sum of LightGCN's E0 at
    the lightgcn-baco smoke config (500 users, 400 items, d = 16,
    K = 60/50, H = 2 with SCU duplicates)."""
    jcfg = dataclasses.replace(smoke_config(), lookup_backend="pallas")
    tcfg = L.LightGCNConfig(jcfg.n_users, jcfg.n_items, jcfg.dim,
                            jcfg.n_layers, k_users=jcfg.k_users,
                            k_items=jcfg.k_items,
                            n_hot_users=jcfg.n_hot_users,
                            lookup_backend="cuda")
    sk_u = _sketch(tcfg.n_users, tcfg.k_users, 2, seed=19)
    sk_v = _sketch(tcfg.n_items, tcfg.k_items, 1, seed=20)
    params = L.init_params(0, tcfg)
    rng = np.random.default_rng(21)
    wu = rng.standard_normal((tcfg.n_users, tcfg.dim)).astype(np.float32)
    wv = rng.standard_normal((tcfg.n_items, tcfg.dim)).astype(np.float32)

    def jl(p):
        u, v = JL._base_embeddings(p, {"sketch_u": jnp.asarray(sk_u),
                                       "sketch_v": jnp.asarray(sk_v)}, jcfg)
        return jnp.sum(u * wu) + jnp.sum(v * wv)

    want = jax.grad(jl)({k: jnp.asarray(v) for k, v in params.items()})
    tp = {k: _t(v).requires_grad_(True) for k, v in params.items()}
    u, v = L._base_embeddings(tp, {"sketch_u": _t(sk_u),
                                   "sketch_v": _t(sk_v)}, tcfg)
    ju, jv = JL._base_embeddings(
        {k: jnp.asarray(v) for k, v in params.items()},
        {"sketch_u": jnp.asarray(sk_u), "sketch_v": jnp.asarray(sk_v)}, jcfg)
    np.testing.assert_array_equal(u.detach().numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.detach().numpy(), np.asarray(jv))
    loss = torch.sum(u * _t(wu)) + torch.sum(v * _t(wv))
    got = torch.autograd.grad(loss, [tp["user_table"], tp["item_table"]])
    for g, name in zip(got, ("user_table", "item_table")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   **GRAD_TOL)


# ---------------------------------------------------------------------------
# the wrappers take the plain versions only for CPU tensors
# ---------------------------------------------------------------------------
def test_new_wrappers_run_plain_versions_on_the_cpu(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(platform, "load", refuse)
    before = (csr_gather_sum.launches, fused_topk_codebook.launches)
    t = torch.randn(6, 4)
    embedding_bag(t, torch.tensor([1, 2]), torch.tensor([0, 0]), 2)
    fused_topk_codebook(torch.randn(2, 4), t,
                        torch.tensor([[0, 1], [2, 2], [5, 3]],
                                     dtype=torch.int32), 2)
    g = TE.EmbeddingEngine(TE.EmbeddingSpec(6, 4), backend="cuda")
    x = t.clone().requires_grad_(True)
    g.full_lookup(x, torch.tensor([1, 1, 3])).sum().backward()
    assert (csr_gather_sum.launches, fused_topk_codebook.launches) == before
    assert x.grad[1].eq(2).all() and x.grad[0].eq(0).all()
    with pytest.raises(ValueError):
        csr_gather_sum(t.to("meta"), torch.zeros(1, dtype=torch.int32),
                       torch.zeros(2, dtype=torch.int64))

"""The port's kernel plain versions against the JAX package's kernels.

The same numpy inputs go through the Pallas kernels (in interpret mode,
as the JAX package's own tests run them on the CPU) and through the
port's kernel wrappers on CPU tensors, which run the plain versions the
CUDA kernels are held against on the card. Tolerance: bitwise for the
codebook lookup (same additions in the same order); for top-k, ids and
values exactly equal on integer-valued inputs, else ids equal and values
within rtol=1e-6 (a different dot-product summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solver_jax
from repro.embedding import quantize_int8_rows as jax_quantize_rows
from repro.kernels import ref as jref
from repro.kernels.codebook_lookup import codebook_lookup_pallas
from repro.kernels.fused_topk import fused_topk_pallas

from repro_torch.core import solver_torch
from repro_torch.embedding import (EmbeddingEngine, EmbeddingSpec,
                                   quantize_int8_rows)
from repro_torch.kernels import codebook_lookup, fused_topk
from repro_torch.kernels.fused_topk import exclusion_csr


def _idx(b, h, k, seed, dup_every=3):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, k, (b, h)).astype(np.int32)
    if h > 1:
        idx[::dup_every, h - 1] = idx[::dup_every, 0]     # repeated rows
    return idx


# ---------------------------------------------------------------------------
# codebook lookup
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h", [1, 2])
@pytest.mark.parametrize("binary", [False, True])
def test_codebook_lookup_matches_pallas(h, binary):
    z = np.random.default_rng(0).standard_normal((37, 24)).astype(np.float32)
    idx = _idx(41, h, 37, seed=h)
    want = np.asarray(codebook_lookup_pallas(jnp.asarray(z), jnp.asarray(idx),
                                             binary=binary, interpret=True))
    got = codebook_lookup(torch.as_tensor(z), torch.as_tensor(idx),
                          binary=binary).numpy()
    np.testing.assert_array_equal(got, want)
    oracle = (jref.codebook_lookup_dedup(z, idx) if binary
              else jref.codebook_lookup(jnp.asarray(z), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, np.asarray(oracle))


def test_engine_backends_agree_and_dedup():
    z = np.random.default_rng(1).standard_normal((29, 16)).astype(np.float32)
    sketch = _idx(50, 2, 29, seed=5, dup_every=2)
    ids = torch.as_tensor(np.random.default_rng(2).integers(0, 50, 33))
    spec = EmbeddingSpec(50, 16, k_rows=29, n_hot=2)
    outs = [EmbeddingEngine(spec, backend=be).codebook_lookup(
        torch.as_tensor(z), torch.as_tensor(sketch), ids).numpy()
        for be in (None, "gather", "cuda")]
    want = np.asarray(jref.codebook_lookup_dedup(z, sketch[ids.numpy()]))
    for got in outs:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# fused top-k
# ---------------------------------------------------------------------------
def _pair(u, v, k, **kw):
    want = fused_topk_pallas(jnp.asarray(u), jnp.asarray(v), k,
                             interpret=True, block=64,
                             **{key: (jnp.asarray(a) if key != "exclude"
                                      else a) for key, a in kw.items()})
    tkw = {key: (torch.as_tensor(a) if key != "exclude"
                 else tuple(torch.as_tensor(x) for x in a))
           for key, a in kw.items()}
    got = fused_topk(torch.as_tensor(u), torch.as_tensor(v), k, **tkw)
    return ([np.asarray(x) for x in want], [x.numpy() for x in got])


def _int_inputs(seed, b=6, n=150, d=8):
    rng = np.random.default_rng(seed)
    u = rng.integers(-2, 3, (b, d)).astype(np.float32)
    v = rng.integers(-2, 3, (n, d)).astype(np.float32)
    return u, v


def _assert_exact(want, got):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_fused_topk_ties_exact():
    u, v = _int_inputs(0)
    want, got = _pair(u, v, 10)
    _assert_exact(want, got)
    rvals, rids = jax.lax.top_k(jnp.asarray(u @ v.T) + 0.0, 10)
    np.testing.assert_array_equal(got[1], np.asarray(rids))


def test_fused_topk_fewer_than_k_finite_and_exclusions():
    u, v = _int_inputs(1)
    mask = np.full(v.shape[0], -np.inf, np.float32)
    mask[[3, 40, 41, 99]] = 0.0
    rng = np.random.default_rng(7)
    rows = np.concatenate([np.repeat(np.arange(6), 2),
                           rng.integers(0, 6, 40)]).astype(np.int32)
    cols = np.concatenate([np.tile([40, 99], 6),
                           rng.integers(0, 150, 40)]).astype(np.int32)
    for kw in (dict(mask=mask), dict(exclude=(rows, cols)),
               dict(mask=mask, exclude=(rows, cols))):
        want, got = _pair(u, v, 12, **kw)
        _assert_exact(want, got)
        if "mask" in kw:      # 4 finite scores: the rest fill with -inf
            assert np.isneginf(got[0][:, 4:]).all()


def test_fused_topk_int8_with_scale():
    rng = np.random.default_rng(3)
    u = rng.standard_normal((5, 16)).astype(np.float32)
    q = rng.integers(-127, 128, (200, 16)).astype(np.int8)
    scale = (rng.random(200) * 0.02 + 1e-3).astype(np.float32)
    want, got = _pair(u, q, 8, scale=scale)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    # integer-valued scores (power-of-two scales): exact
    ui = rng.integers(-2, 3, (5, 16)).astype(np.float32)
    pow2 = (2.0 ** rng.integers(-3, 2, 200)).astype(np.float32)
    want, got = _pair(ui, q, 8, scale=pow2)
    _assert_exact(want, got)


def test_fused_topk_random_floats():
    rng = np.random.default_rng(4)
    u = rng.standard_normal((7, 32)).astype(np.float32)
    v = rng.standard_normal((300, 32)).astype(np.float32)
    want, got = _pair(u, v, 20)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    rv, ri = jref.fused_topk(u, v, 20)
    np.testing.assert_array_equal(got[1], np.asarray(ri))


def test_fused_topk_rejects_k_above_n():
    with pytest.raises(ValueError):
        fused_topk(torch.zeros(2, 4), torch.zeros(3, 4), 4)


def test_exclusion_csr_rows_sorted_and_filtered():
    ptr, ids = exclusion_csr((np.array([2, 0, 2, 2, 5, -1]),
                              np.array([9, 4, 1, 7, 0, 3])), 3, 8, "cpu")
    assert ptr.tolist() == [0, 1, 1, 3]       # col 9 and rows 5/-1 dropped
    assert ids.tolist() == [4, 1, 7]


def test_quantize_rows_bitwise():
    x = np.random.default_rng(5).standard_normal((40, 12)).astype(np.float32)
    for a, b in zip(quantize_int8_rows(x), jax_quantize_rows(x)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the solver's arithmetic primitives against XLA's
# ---------------------------------------------------------------------------
def test_fma_sub_matches_xla_contraction():
    """XLA on the CPU fuses cnt - (g*x)*y into one FMA; fma_sub must
    round the same way (inputs chosen so that a separately rounded
    product differs in ~40% of the lanes)."""
    rng = np.random.default_rng(0)
    n = 50_000
    cnt = rng.integers(1, 3, n).astype(np.float32)
    x = (rng.random(n) + 0.5).astype(np.float32)
    y = (rng.random(n) + 0.5).astype(np.float32)
    g = np.float32(0.7)
    want = np.asarray(jax.jit(lambda c, a, b, g: c - g * a * b)(cnt, x, y, g))
    tx = torch.as_tensor(g) * torch.as_tensor(x)
    got = solver_torch.fma_sub(tx, torch.as_tensor(y),
                               torch.as_tensor(cnt)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.mean(cnt - (g * x) * y != want) > 0.1


def test_segment_sum_ordered_is_xla_segment_sum():
    rng = np.random.default_rng(1)
    w = rng.random(20_000).astype(np.float32)
    seg = rng.integers(0, 300, 20_000)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(w), jnp.asarray(seg),
                                          num_segments=310))
    stats = {}
    got = solver_torch.segment_sum_ordered(
        torch.as_tensor(w), torch.as_tensor(seg), 310, stats).numpy()
    np.testing.assert_array_equal(got, want)
    assert stats == {"host_syncs": 1}


def test_count_side_labels_matches():
    lab = np.random.default_rng(2).integers(0, 60, 90).astype(np.int32)
    want = [int(x) for x in solver_jax.count_side_labels(
        jnp.asarray(lab), n_users=40, n_items=50)]
    got = [int(x) for x in solver_torch.count_side_labels(
        torch.as_tensor(lab).long(), 40, 50)]
    assert got == want

"""Serving across the packages: artifacts, sessions, dispatcher.

An artifact built with the JAX package is saved by ``repro.serve`` and
loaded by the port (and the other way round) with the same
``content_id()``; both packages' sessions then return identical top-k
ids for the dense and fused scorers, fp32 and int8; the port's
BatchDispatcher chunks exactly as the reference's.

Identical ids need identical scores: the two packages sum in different
orders (prefix scans, dot products), so two items whose scores are an
ulp apart can swap. The ``exact`` artifact therefore holds data on which
every sum is exact in f32 (sparse codebooks of ±127/64, whose int8
quantization is lossless; unit edge weights; one layer), so scores agree
bit for bit and exact ties (there are many) test the tie order. The
``seeded`` artifact (random codebooks, true edge norms) checks the
realistic case: ids equal except where two scores are within 1e-5.
The dense scorer ranks in ``lax.top_k``'s total order of f32 bits
(±0 and ±NaN apart), checked against JAX on planted scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Sketch as JaxSketch
from repro.serve import BatchDispatcher as JaxDispatcher
from repro.serve import CompressedArtifact as JaxArtifact
from repro.serve import RecsysSession as JaxSession
from repro.serve.dispatch import chunk_plan as jax_chunk_plan

from repro_torch.core import ClusterEngine
from repro_torch.data import planted_coclusters
from repro_torch.kernels import ref
from repro_torch.kernels.ref import topk_total_order
from repro_torch.models.lightgcn import edge_norms, from_sketch, init_params
from repro_torch.serve import (BatchDispatcher, CompressedArtifact,
                               RecsysSession, chunk_plan)

K = 10


def _jax_artifact(g, sk, params, edge_norm, n_layers):
    """A CompressedArtifact of the JAX package over numpy state."""
    cfg = from_sketch(g, sk, dim=params["user_table"].shape[1],
                      n_layers=n_layers)
    sk_j = JaxSketch(sk.user_idx, sk.item_idx, sk.k_users, sk.k_items,
                     method=sk.method, meta=sk.meta)
    model = {k: getattr(cfg, k) for k in (
        "n_users", "n_items", "dim", "n_layers", "l2", "k_users", "k_items",
        "n_hot_users", "lookup_backend")}
    return JaxArtifact(params=params,
                       edges={"edge_u": g.edge_u, "edge_v": g.edge_v,
                              "edge_norm": edge_norm},
                       sketch=sk_j, model=model,
                       provenance=sk_j.meta_json())


@pytest.fixture(scope="module")
def jax_artifact():
    """Exact-arithmetic data (see the module docstring)."""
    g, _, _ = planted_coclusters(120, 100, 5, 3, seed=3)
    sk = ClusterEngine(device="cpu").build(g, d=4, ratio=0.3)
    rng = np.random.default_rng(11)
    params = {}
    for name, rows in (("user_table", sk.k_users), ("item_table", sk.k_items)):
        t = np.zeros((rows, 4), np.float32)
        t[np.arange(rows), rng.integers(0, 4, rows)] = \
            rng.choice([-1.0, 1.0], rows) * 127 / 64
        params[name] = t
    return _jax_artifact(g, sk, params, np.ones(g.n_edges, np.float32), 1)


@pytest.fixture(scope="module")
def seeded_artifact():
    g, _, _ = planted_coclusters(300, 240, 10, 8, seed=3)
    sk = ClusterEngine(device="cpu").build(g, d=16, ratio=0.3)
    return _jax_artifact(g, sk, init_params(11, from_sketch(g, sk, dim=16)),
                         edge_norms(g), 2)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_jax_artifact_loads_in_port(tmp_path, jax_artifact, quantized):
    art = jax_artifact.quantize() if quantized else jax_artifact
    path = art.save(str(tmp_path / "jax_art"))
    got = CompressedArtifact.load(path)
    assert got.content_id() == art.content_id()
    assert got.model == art.model
    np.testing.assert_array_equal(got.sketch.user_idx, art.sketch.user_idx)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_port_artifact_loads_in_reference(tmp_path, jax_artifact, quantized):
    port = CompressedArtifact.from_parts(
        jax_artifact.params, jax_artifact.edges,
        CompressedArtifact.load(jax_artifact.save(str(tmp_path / "a"))).sketch,
        jax_artifact.model)
    if quantized:
        port = port.quantize()
    path = port.save(str(tmp_path / "port_art"))
    ref = JaxArtifact.load(path)
    assert ref.content_id() == port.content_id()
    want = jax_artifact.quantize() if quantized else jax_artifact
    assert port.content_id() == want.content_id()


def _both_sessions(tmp_path, art, scorer, ids):
    loaded = CompressedArtifact.load(art.save(str(tmp_path / "art")))
    want = JaxSession.from_artifact(art, k=K, scorer=scorer)(
        jnp.asarray(ids))
    got = RecsysSession.from_artifact(loaded, k=K, scorer=scorer,
                                      device="cpu")(ids)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("scorer", ["dense", "fused"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_topk_ids_identical_across_packages(tmp_path, jax_artifact, scorer,
                                            quantized):
    art = jax_artifact.quantize() if quantized else jax_artifact
    if quantized:       # lossless: the int8 payload serves the same tables
        for name in ("user_table", "item_table"):
            np.testing.assert_array_equal(
                art.quantized[name + "_q"].astype(np.float32)
                * art.quantized[name + "_scale"][:, None],
                jax_artifact.params[name])
    (wv, wi), (gv, gi) = _both_sessions(tmp_path, art, scorer,
                                        np.arange(120, dtype=np.int32))
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv, wv)
    # many exact ties: the tie order is tested too
    assert (np.diff(wv, axis=1) == 0).sum() > 100


@pytest.mark.parametrize("scorer", ["dense", "fused"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_topk_ids_equal_up_to_near_ties_seeded(tmp_path, seeded_artifact,
                                               scorer, quantized):
    art = seeded_artifact.quantize() if quantized else seeded_artifact
    (wv, wi), (gv, gi) = _both_sessions(tmp_path, art, scorer,
                                        np.arange(0, 300, 11, dtype=np.int32))
    np.testing.assert_allclose(gv, wv, rtol=1e-5, atol=1e-7)
    diff = gi != wi
    assert diff.mean() < 0.02
    np.testing.assert_allclose(gv[diff], wv[diff], rtol=1e-5)


def _planted_scores(n_users, n_items, seed):
    """Seeded f32 scores [n_users, n_items] with ±0, ±NaN, ±inf and
    exact ties planted in every row; row 0 starts with the probe row
    [+0, -0, 1, -inf, NaN, -NaN, +0, -0]."""
    rng = np.random.default_rng(seed)
    s = rng.integers(-3, 4, (n_users, n_items)).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, np.nan],
                       np.float32)
    cells = rng.random((n_users, n_items)) < 0.4
    s[cells] = rng.choice(special, int(cells.sum()))
    neg_nan = rng.random((n_users, n_items)) < 0.1
    bits = s.view(np.uint32)
    bits[neg_nan] = 0xFFC00000                  # NaN with the sign bit set
    probe = np.array([0.0, -0.0, 1.0, -np.inf, np.nan, 0.0, 0.0, -0.0],
                     np.float32)
    probe.view(np.uint32)[5] = 0xFFC00000
    s[0, :8] = probe
    return s


@pytest.mark.parametrize("row", ["probe", "seeded"])
def test_dense_topk_total_order_matches_lax_top_k(row):
    """The dense scorer's top-k against ``jax.lax.top_k``, ids and value
    bits: +NaN first, +0 above -0, a sign-bit NaN last."""
    s = _planted_scores(7, 53, seed=5)
    if row == "probe":
        s = s[:1, :8]
    for k in (1, 3, s.shape[1]):
        want_v, want_i = jax.lax.top_k(jnp.asarray(s), k)
        got_v, got_i = topk_total_order(torch.as_tensor(s), k)
        assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy().view(np.uint32),
                                      np.asarray(want_v).view(np.uint32))
    if row == "probe":
        assert got_i.tolist() == [[4, 2, 0, 6, 1, 7, 3, 5]]


def test_dense_session_ranks_like_lax_top_k(monkeypatch, tmp_path,
                                            jax_artifact):
    """Both packages' dense sessions over the same planted scores (each
    package's ``score_all_items`` replaced by a lookup of one table):
    ids and value bits equal, where the fused kernels' order differs."""
    import repro.models.lightgcn as jax_lightgcn
    import repro_torch.models.lightgcn as torch_lightgcn

    n_items = jax_artifact.model["n_items"]
    table = _planted_scores(jax_artifact.model["n_users"], n_items, seed=9)
    monkeypatch.setattr(jax_lightgcn, "score_all_items",
                        lambda p, st, c, ids: jnp.asarray(table)[ids])
    monkeypatch.setattr(torch_lightgcn, "score_all_items",
                        lambda p, st, c, ids: torch.as_tensor(table)[ids])
    ids = np.arange(40, dtype=np.int32)
    (wv, wi), (gv, gi) = _both_sessions(tmp_path, jax_artifact, "dense", ids)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gv.view(np.uint32), wv.view(np.uint32))
    _, fused_order = ref.topk(torch.as_tensor(table[ids]), K)
    assert not np.array_equal(fused_order.numpy(), gi)


def test_chunk_plan_matches_reference():
    for buckets in ((1, 8, 64, 512), (3, 17), (5,)):
        for n in list(range(1, 200)) + [511, 512, 513, 1100, 1537]:
            assert chunk_plan(n, buckets) == jax_chunk_plan(n, buckets)
    with pytest.raises(ValueError):
        chunk_plan(0, (1, 8))


def test_dispatcher_matches_reference(jax_artifact):
    buckets = (1, 8, 64)
    jd = JaxDispatcher(JaxSession.from_artifact(jax_artifact, k=K),
                       buckets=buckets)
    port = CompressedArtifact.from_parts(
        jax_artifact.params, jax_artifact.edges,
        _port_sketch(jax_artifact), jax_artifact.model)
    session = RecsysSession.from_artifact(port, k=K, device="cpu")
    pd = BatchDispatcher(session, buckets=buckets)
    rng = np.random.default_rng(0)
    for n in (1, 5, 64, 65, 150):
        req = rng.integers(0, 120, n)
        want = jd(req)
        got = pd(req)
        assert got[1].shape == (n, K) and isinstance(got[1], np.ndarray)
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        direct = session(req)[1].numpy()
        np.testing.assert_array_equal(got[1], direct)
    assert pd.stats()["bucket_counts"] == jd.stats()["bucket_counts"]
    assert pd.bucket_for(9) == 64
    with pytest.raises(ValueError):
        pd.bucket_for(65)


def _port_sketch(art):
    from repro_torch.core import Sketch
    return Sketch(art.sketch.user_idx, art.sketch.item_idx,
                  art.sketch.k_users, art.sketch.k_items,
                  method=art.sketch.method, meta=art.sketch.meta)


def test_session_stats_and_scorer_validation(jax_artifact):
    port = CompressedArtifact.from_parts(
        jax_artifact.params, jax_artifact.edges, _port_sketch(jax_artifact),
        jax_artifact.model).quantize()
    s = port.session(k=K, scorer="fused", device="cpu")
    s.warmup(4)
    s(np.array([1, 2, 3]))
    st = s.stats()
    assert (st["scorer"], st["quantized"], st["requests"]) == ("fused", True,
                                                               1)
    with pytest.raises(ValueError):
        port.session(scorer="nope", device="cpu")
    with pytest.raises(KeyError):
        port.session(backend="pallas", device="cpu")
    assert isinstance(s.params["user_table_q"], torch.Tensor)

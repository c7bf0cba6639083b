"""The port's stream layer against the JAX package's, on the CPU.

Same numpy inputs through ``repro`` and ``repro_torch``: the drift
stream ``drifting_coclusters(600, 480, k_true=12, avg_deg=10, T=3)``,
its warm prefix clustered by both packages (identical sketches), and
the reference's bootstrap codebooks (a 25-step reference trainer)
carried into both updaters.

What is held, and how exactly:
  * ``StreamingGraph`` appends equal a one-shot rebuild (and the
    reference's StreamingGraph), ``grow_labels``, the drift stream, the
    minhash candidate sets, the metrics: bitwise.
  * ``lp_cold_assign`` (exact and minhash candidates) and
    ``lp_solve_capped`` (two budgets, warm and cold, user/item/edge
    padding and edge padding alone): labels bitwise the reference's and
    the port's unpadded ``lp_solve``, iteration counts equal.
  * ``ColdStartAssigner.refresh``: labels, gamma and sweeps equal.
  * An update-only replay (``tune_steps=0``): the sketch at every step
    bitwise, and every exported artifact's ``content_id`` equal.
  * ``CapacityTuner``: on the padded state, the BPR loss and gradients
    equal the unpadded state's bitwise on the real rows (0 on the pads),
    and the loss the reference's padded loss to rtol 1e-5; the codebooks
    after 10 tuning steps within rtol 1e-4 / atol 2e-5 of the
    reference's. Adam divides each element's step by its gradient's
    running RMS, so where a gradient's terms nearly cancel, the two
    packages' f32 sums (a fold in edge order against a tree prefix scan)
    move the element by different fractions of lr (5e-3): the reference
    differs from itself by 1.3e-6 when only its padding changes, and
    from the port by up to 9.2e-6 on 2 of 1,632 elements of this input.
    2e-5 is 4e-3 x lr.
  * Artifact deltas: round trip, wrong base refused, save/load, and a
    delta crossing the packages both ways; an identical pair's delta is
    empty.

``python tests/test_torch_stream.py`` prints the reference's pinned
values for ``chip_smoke.py``'s stream phase (``STREAM_REFERENCE``).
The module runs with one intra-op thread (``one_thread``).
"""
import hashlib
import json
import sys

import numpy as np
import pytest
import torch

import repro.core as RC
import repro.data as RD
import repro.stream as RS
from repro.core import solver_jax
from repro.serve import ArtifactDelta as JaxDelta
from repro.serve import CompressedArtifact as JaxArtifact

import repro_torch.core as TC
import repro_torch.data as TD
import repro_torch.stream as TS
from repro_torch.core import candidates as tcand
from repro_torch.core import metrics as tmetrics
from repro_torch.core import solver_torch
from repro_torch.serve import ArtifactDelta, CompressedArtifact
from repro_torch.serve.telemetry import StreamTelemetry

STREAM = dict(n_users=600, n_items=480, k_true=12, avg_deg=10, T=3)
D = 16
MODEL = {"dim": D, "n_layers": 3, "l2": 1e-4, "lookup_backend": None}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many tiny ops, and several
    test processes share the machine; idle OpenMP threads spinning
    between ops would slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha(a) -> str:
    """The first 32 hex digits of the sha256 of an array's bytes."""
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:32]


def caps_for(stream) -> dict:
    """The launcher's capacity caps for a stream."""
    return {"n_users": stream.n_users, "n_items": stream.n_items,
            "k_users": stream.n_users // 2, "k_items": stream.n_items // 2,
            "n_edges": stream.base.n_edges
            + sum(s.edge_u.size for s in stream.steps)}


def _tgraph(g):
    return TC.BipartiteGraph.from_edges(g.n_users, g.n_items, g.edge_u,
                                        g.edge_v)


@pytest.fixture(scope="module")
def boot():
    """Both packages' streams and bootstrap sketches, and the reference's
    bootstrap codebooks (25 steps of its trainer)."""
    from repro.training import TrainConfig, Trainer
    rs = RD.drifting_coclusters(**STREAM)
    ts = TD.drifting_coclusters(**STREAM)
    rsk = RC.ClusterEngine().build(rs.base, d=D, ratio=0.25)
    tsk = TC.ClusterEngine(device="cpu").build(ts.base, d=D, ratio=0.25)
    tr = Trainer(rs.base, rsk, TrainConfig(dim=D, steps=25, batch_size=256,
                                           lr=5e-3))
    tr.run(log_every=0)
    params = {k: np.asarray(v) for k, v in tr.params.items()}
    return dict(rs=rs, ts=ts, rsk=rsk, tsk=tsk, params=params)


def updaters(boot, capacity=True):
    caps = caps_for(boot["rs"]) if capacity else None
    ru = RS.StreamUpdater(boot["rs"].base, boot["rsk"], boot["params"], MODEL,
                          engine=RC.ClusterEngine(), capacity=caps)
    tu = TS.StreamUpdater(boot["ts"].base, boot["tsk"], boot["params"], MODEL,
                          engine=TC.ClusterEngine(device="cpu"),
                          capacity=caps)
    return ru, tu


@pytest.fixture(scope="module")
def grown(boot):
    """The graph after the stream's first step, with labels grown from
    the bootstrap partition (cold nodes on fresh singletons)."""
    rs = boot["rs"]
    step = rs.steps[0]
    sg = RS.StreamingGraph.from_graph(rs.base)
    nu0, nv0 = rs.base.n_users, rs.base.n_items
    sg.grow(nu0 + step.n_new_users, nv0 + step.n_new_items)
    sg.append(step.edge_u, step.edge_v)
    g = sg.graph
    lab = RS.grow_labels(boot["rsk"].meta["joint_labels"], nu0, nv0,
                         g.n_users, g.n_items)
    return dict(g=g, tg=_tgraph(g), lab=lab, du=step.n_new_users,
                dv=step.n_new_items)


# ---------------------------------------------------------------------------
# graph, labels, stream generator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_streaming_append_equals_rebuild_and_reference(seed):
    rng = np.random.default_rng(seed)
    nu, nv, ne = 180, 150, 4000
    eu = rng.integers(0, nu, ne)
    ev = rng.integers(0, nv, ne)
    ref = RC.BipartiteGraph.from_edges(nu, nv, eu, ev)
    pre = (eu < 60) & (ev < 50)
    cuts = np.sort(rng.choice(ne, size=rng.integers(1, 6), replace=False))
    graphs = []
    for mod in (TS, RS):
        sg = mod.StreamingGraph(60, 50)
        sg.append(eu[pre], ev[pre])
        sg.grow(nu, nv)
        for lo, hi in zip(np.r_[0, cuts], np.r_[cuts, ne]):
            sg.append(eu[lo:hi], ev[lo:hi])
        graphs.append(sg)
    tsg, rsg = graphs
    g = tsg.graph
    assert tsg.version == rsg.version and tsg.n_edges == ref.n_edges
    for name in ("edge_u", "edge_v", "perm_by_item"):
        assert np.array_equal(getattr(g, name), getattr(ref, name))
    assert np.array_equal(g.user_degrees(), ref.user_degrees())
    assert np.array_equal(g.item_degrees(), ref.item_degrees())
    for a, b in zip(g.user_csr() + g.item_csr() + g.edges_by_item(),
                    ref.user_csr() + ref.item_csr() + ref.edges_by_item()):
        assert np.array_equal(a, b)
    assert g.user_degrees() is tsg.user_degrees()      # seeded memo
    chunked = TC.BipartiteGraph.from_edges(nu, nv, eu, ev, chunk_size=333)
    assert np.array_equal(chunked.edge_u, ref.edge_u)
    assert np.array_equal(chunked.edge_v, ref.edge_v)


def test_streaming_append_dedup_touched_and_grow():
    out = []
    for mod in (TS, RS):
        sg = mod.StreamingGraph(4, 4)
        infos = [sg.append([0, 0, 1], [1, 1, 2]), sg.append([0, 2], [1, 3])]
        g_old = sg.graph
        deg_old = g_old.user_degrees().copy()
        sg.append([3], [0])
        assert np.array_equal(g_old.user_degrees(), deg_old)   # frozen
        sg.grow(5, 7)                           # item growth re-encodes
        with pytest.raises(ValueError):
            sg.grow(4, 7)
        infos.append(sg.append([4], [6]))
        with pytest.raises(ValueError):
            sg.append([0], [99])
        out.append((infos, sg.graph))
    (ti, tg), (ri, rg) = out
    assert [(i.n_appended, i.n_new_edges, i.touched_users.tolist(),
             i.touched_items.tolist()) for i in ti] == \
        [(i.n_appended, i.n_new_edges, i.touched_users.tolist(),
          i.touched_items.tolist()) for i in ri]
    assert ti[0].n_new_edges == 2 and ti[1].n_new_edges == 1
    assert np.array_equal(tg.edge_u, rg.edge_u)
    assert np.array_equal(tg.edge_v, rg.edge_v)


def test_grow_labels_matches_reference():
    lab = np.random.default_rng(0).integers(0, 70, 70).astype(np.int32)
    for sizes in ((30, 40, 30, 40), (30, 40, 35, 40), (30, 40, 30, 49),
                  (30, 40, 41, 52)):
        got = TS.grow_labels(lab, *sizes)
        want = RS.grow_labels(lab, *sizes)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        TS.grow_labels(lab, 30, 40, 29, 40)
    with pytest.raises(ValueError):
        TS.grow_labels(lab[:-1], 30, 40, 30, 40)


@pytest.mark.parametrize("seed", [0, 7])
def test_drifting_coclusters_is_the_reference_stream(seed):
    a = TD.drifting_coclusters(**STREAM, seed=seed)
    b = RD.drifting_coclusters(**STREAM, seed=seed)
    assert (a.n_warm_users, a.n_warm_items) == (b.n_warm_users,
                                                b.n_warm_items)
    assert np.array_equal(a.base.edge_u, b.base.edge_u)
    assert np.array_equal(a.base.edge_v, b.base.edge_v)
    assert np.array_equal(a.true_uc, b.true_uc)
    assert np.array_equal(a.true_ic, b.true_ic)
    assert len(a.steps) == len(b.steps) == STREAM["T"]
    for sa, sb in zip(a.steps, b.steps):
        assert (sa.n_new_users, sa.n_new_items) == (sb.n_new_users,
                                                    sb.n_new_items)
        assert sa.edge_u.dtype == sb.edge_u.dtype
        assert np.array_equal(sa.edge_u, sb.edge_u)
        assert np.array_equal(sa.edge_v, sb.edge_v)
    for x, y in zip(a.full_edges(), b.full_edges()):
        assert np.array_equal(x, y)


# ---------------------------------------------------------------------------
# solver: cold assignment, capped solve, refresh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("candidates", ["exact", "minhash"])
@pytest.mark.parametrize("gamma", [0.0, 1.0, 8.0])
def test_lp_cold_assign_bitwise(grown, candidates, gamma):
    g, tg, lab = grown["g"], grown["tg"], grown["lab"]
    wu, wv = RC.make_weights(g, "hws")
    cand = t_cand = None
    if candidates == "minhash":
        from repro.core.candidates import cold_candidate_sets
        cand = cold_candidate_sets(g, lab, grown["du"], grown["dv"])
        t_cand = tcand.cold_candidate_sets(tg, lab, grown["du"], grown["dv"])
        for side in ("user", "item"):
            for x, y in zip(t_cand[side], cand[side]):
                assert np.array_equal(x, y)
    want = solver_jax.lp_cold_assign(g, lab, wu, wv, gamma, grown["du"],
                                     grown["dv"], cand_labels=cand)
    stats = {}
    got = solver_torch.lp_cold_assign(tg, lab, wu, wv, gamma, grown["du"],
                                      grown["dv"], cand_labels=t_cand,
                                      device="cpu", stats=stats)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert (got != lab).sum() > 0 and stats["host_syncs"] == 2
    n0u = g.n_users - grown["du"]
    assert np.array_equal(got[:n0u], lab[:n0u])        # old nodes stay
    assert np.array_equal(solver_torch.lp_cold_assign(
        tg, lab, wu, wv, gamma, 0, 0, device="cpu"), lab)


@pytest.mark.parametrize("budget", [None, 115])
@pytest.mark.parametrize("warm", [False, True])
def test_lp_solve_capped_bitwise(boot, budget, warm):
    g = boot["rs"].base
    tg = _tgraph(g)
    wu, wv = RC.make_weights(g, "hws")
    init = None
    if warm:
        init, _ = solver_jax.lp_solve(g, wu, wv, 16.0, None, 3)
    plain, ip = solver_torch.lp_solve(tg, wu, wv, 1.0, budget, 8,
                                      init_labels=init, device="cpu")
    for caps in ({"n_users": 2 * g.n_users, "n_items": 2 * g.n_items,
                  "n_edges": 2 * g.n_edges},
                 {"n_edges": 4 * g.n_edges}):
        want, iw = solver_jax.lp_solve_capped(g, wu, wv, 1.0, budget, 8,
                                              init_labels=init, caps=caps)
        got, it = solver_torch.lp_solve_capped(tg, wu, wv, 1.0, budget, 8,
                                               init_labels=init, caps=caps,
                                               device="cpu")
        assert np.array_equal(got, want) and it == iw
        assert np.array_equal(got, plain) and it == ip
        assert got.max() < g.n_nodes                  # pad label unseen


@pytest.mark.parametrize("capped", [False, True])
def test_refresh_matches_reference(boot, capped):
    ru, tu = updaters(boot, capacity=capped)
    for up in (ru, tu):
        step = boot["rs"].steps[0]
        up.apply_events(step.n_new_users, step.n_new_items, step.edge_u,
                        step.edge_v)
    assert np.array_equal(tu.labels, ru.labels)
    rr, tr = ru.refresh(), tu.refresh()
    assert (tr.iters, tr.gamma) == (rr.iters, rr.gamma)
    assert (tr.churn_users, tr.churn_items) == (rr.churn_users,
                                                rr.churn_items)
    assert np.array_equal(tu.labels, ru.labels)
    assert np.array_equal(tu.su, ru.su)
    assert np.array_equal(tu.sketch.user_idx, ru.sketch.user_idx)
    assert np.array_equal(tu.sketch.item_idx, ru.sketch.item_idx)


def test_minhash_refresh_and_candidates_match_reference(boot, grown):
    from repro.core.candidates import MinHashIndex, candidate_recall, \
        prune_graph
    g, tg, lab = grown["g"], grown["tg"], grown["lab"]
    pr, kr = prune_graph(g, lab)
    pt, kt = tcand.prune_graph(tg, lab)
    assert kt == kr and np.array_equal(pt.edge_u, pr.edge_u)
    assert np.array_equal(pt.edge_v, pr.edge_v)
    iptr, neigh = g.user_csr()
    for x, y in zip(tcand.MinHashIndex(seed=3).fit(iptr, neigh).query(
            iptr, neigh), MinHashIndex(seed=3).fit(iptr, neigh).query(
            iptr, neigh)):
        assert np.array_equal(x, y)
    cand = tcand.cold_candidate_sets(tg, lab, grown["du"], 0)["user"]
    chosen = lab[g.n_users - grown["du"]:g.n_users]
    assert tcand.candidate_recall(cand, chosen, chosen) == \
        candidate_recall(cand, chosen, chosen) == 1.0
    # a minhash engine's refresh sweeps the pruned graph in both packages
    ra = RS.ColdStartAssigner(engine=RC.ClusterEngine(candidates="minhash"))
    ta = TS.ColdStartAssigner(engine=TC.ClusterEngine(
        device="cpu", candidates="minhash"))
    (rl, rst), (tl, tst) = ra.refresh(g, lab), ta.refresh(tg, lab)
    assert np.array_equal(tl, rl) and (tst.iters, tst.gamma) == (rst.iters,
                                                                rst.gamma)
    with pytest.raises(ValueError, match="candidates"):
        TC.ClusterEngine(device="cpu", candidates="lsh")


def test_metrics_match_reference(grown):
    from repro.core import metrics as rmetrics
    g, tg, lab = grown["g"], grown["tg"], grown["lab"]
    wu, wv = RC.make_weights(g, "hws")
    for name in ("bipartite_modularity", "bipartite_cpm", "intra_edges",
                 "accl"):
        assert getattr(tmetrics, name)(tg, lab) == \
            getattr(rmetrics, name)(g, lab), name
    assert tmetrics.objective(tg, lab, wu, wv, 0.5) == \
        rmetrics.objective(g, lab, wu, wv, 0.5)
    sizes = tmetrics.cluster_sizes(lab)
    assert np.array_equal(sizes, rmetrics.cluster_sizes(lab))
    assert tmetrics.gini(sizes) == rmetrics.gini(sizes)


# ---------------------------------------------------------------------------
# the updater: an update-only replay, the tuner
# ---------------------------------------------------------------------------
def _record_exports(up):
    ids = []
    export = up.export_artifact

    def wrapped():
        art = export()
        ids.append(art.content_id())
        return art
    up.export_artifact = wrapped
    return ids


def test_update_only_replay_is_bitwise(boot):
    """tune_steps=0: every step's sketch bitwise, every export's
    content_id equal, and the replay reports the reference's keys."""
    ru, tu = updaters(boot)
    sketches = {"r": [], "t": []}
    reports = {}
    for key, up, mod in (("r", ru, RS), ("t", tu, TS)):
        ids = _record_exports(up)
        reports[key] = mod.replay(
            up, (boot["rs"] if key == "r" else boot["ts"]).steps, None,
            mod.ReplayConfig(refresh_every=2, tune_steps=0),
            log=lambda line, up=up, key=key: sketches[key].append(
                (up.sketch.user_idx.copy(), up.sketch.item_idx.copy(),
                 up.labels.copy(), up.sketch.k_users, up.sketch.k_items)))
        reports[key]["ids"] = ids
    assert len(sketches["t"]) == len(sketches["r"]) == STREAM["T"]
    for a, b in zip(sketches["t"], sketches["r"]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    assert reports["t"]["ids"] == reports["r"]["ids"]
    assert len(reports["t"]["ids"]) == STREAM["T"] + 1
    assert set(reports["t"]) == set(reports["r"])
    assert reports["t"]["telemetry"].keys() == reports["r"]["telemetry"].keys()
    for key in ("appends", "new_edges", "cold_users", "cold_items",
                "refreshes", "churn_mean"):
        assert reports["t"]["telemetry"][key] == \
            reports["r"]["telemetry"][key]
    assert reports["t"]["final_artifact"].content_id() == \
        reports["r"]["final_artifact"].content_id()


@pytest.fixture(scope="module")
def replayed(boot):
    ru, tu = updaters(boot)
    for up, mod, s in ((ru, RS, boot["rs"]), (tu, TS, boot["ts"])):
        mod.replay(up, s.steps, None, mod.ReplayConfig(refresh_every=2,
                                                       tune_steps=0))
    return ru, tu


def test_capacity_padding_leaves_real_gradients_unchanged(replayed):
    """The padded state's BPR loss and gradients (one sampler batch)
    equal the unpadded state's bitwise on the real rows, and are 0 on the
    pad rows; the loss equals the reference's padded loss to rtol 1e-5."""
    import jax
    import jax.numpy as jnp
    from repro.models import lightgcn as JL
    from repro.serve.session import _pad_state as jpad
    from repro.serve.session import capacity_plan as jplan

    from repro_torch.data import BPRSampler
    from repro_torch.models import lightgcn as L
    from repro_torch.serve.session import _pad_state, capacity_plan
    ru, tu = replayed
    caps = tu.capacity
    tg = tu.sgraph.graph
    mt = L.from_sketch(tg, tu.sketch, dim=D, n_layers=3)
    st = {k: v.numpy() for k, v in L.make_statics(tg, tu.sketch,
                                                  "cpu").items()}
    pt, spt, mpt = _pad_state(tu.params, st, mt, capacity_plan(mt, st,
                                                               **caps))
    u, p, n = BPRSampler(tg, 256, seed=5).next_batch()
    batch = {"user": torch.as_tensor(u), "pos": torch.as_tensor(p),
             "neg": torch.as_tensor(n)}
    names = sorted(pt)
    out = []
    for params, statics, cfg in ((tu.params, st, mt), (pt, spt, mpt)):
        tp = {k: torch.as_tensor(v).requires_grad_(True)
              for k, v in params.items()}
        loss = L.bpr_loss_fn(tp, {k: torch.as_tensor(v)
                                  for k, v in statics.items()}, batch, cfg)
        out.append((loss.detach(), torch.autograd.grad(
            loss, [tp[k] for k in names])))
    (loss, grads), (loss_p, grads_p) = out
    assert torch.equal(loss, loss_p)
    for name, gr, gp in zip(names, grads, grads_p):
        rows = len(tu.params[name])
        assert gp.shape[0] > rows
        assert torch.equal(gr, gp[:rows]) and not gp[rows:].any(), name
    g, sk = ru.sgraph.graph, ru.sketch
    mj = JL.from_sketch(g, sk, dim=D, n_layers=3)
    sj = JL.make_statics(g, sk)
    pj, sj, mj = jpad(ru.params, sj, mj, jplan(mj, sj, **caps))
    assert (mpt.n_users, mpt.n_items, mpt.k_users, mpt.k_items) == \
        (mj.n_users, mj.n_items, mj.k_users, mj.k_items)
    jb = {"user": jnp.asarray(u), "pos": jnp.asarray(p), "neg": jnp.asarray(n)}
    want = jax.jit(lambda q: JL.bpr_loss_fn(q, sj, jb, mj))(
        {k: jnp.asarray(v) for k, v in pj.items()})
    np.testing.assert_allclose(float(loss_p), float(want), rtol=1e-5,
                               atol=1e-6)


def test_capacity_tuner_10_steps_matches_reference(replayed):
    ru, tu = replayed
    seed = ru.sgraph.version
    rt = RS.CapacityTuner(ru.model, lr=5e-3, batch_size=1024,
                          caps=ru.capacity)
    tt = TS.CapacityTuner(tu.model, lr=5e-3, batch_size=1024,
                          caps=tu.capacity, device="cpu")
    want = rt.tune(ru.sgraph.graph, ru.sketch, ru.params, 10, seed=seed)
    got = tt.tune(tu.sgraph.graph, tu.sketch, tu.params, 10, seed=seed)
    for k in ("user_table", "item_table"):
        assert got[k].shape == want[k].shape == tu.params[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-5)
    # a second tune in the same rungs reuses every padded buffer
    n_alloc = tt.state_allocations
    ptrs = {k: v.data_ptr() for k, v in tt._params.items()}
    tt.tune(tu.sgraph.graph, tu.sketch, got, 2, seed=seed + 1)
    assert tt.state_allocations == n_alloc
    assert ptrs == {k: v.data_ptr() for k, v in tt._params.items()}


def test_updater_requires_joint_labels():
    g, _, _ = TD.planted_coclusters(40, 30, 4, 4, seed=2)
    sk = TC.Sketch(np.zeros((40, 1), np.int32), np.zeros((30, 1), np.int32),
                   1, 1)
    with pytest.raises(ValueError, match="joint labels"):
        TS.StreamUpdater(g, sk, {"user_table": np.zeros((1, 4)),
                                 "item_table": np.zeros((1, 4))},
                         {"dim": 4}, device="cpu")


def test_stream_telemetry_summary_matches_reference():
    from repro.serve.telemetry import StreamTelemetry as JaxTelemetry
    out = []
    for tele in (StreamTelemetry(), JaxTelemetry()):
        tele.bump("appends")
        tele.bump("new_edges", 17)
        tele.record_churn(0.25)
        tele.record_churn(0.5)
        for ms in (1.0, 2.0, 4.0):
            tele.swap.record(ms)
        out.append(tele.summary())
    assert list(out[0]) == list(out[1]) and out[0] == out[1]
    assert out[0]["capacity_bumps"] == 0


# ---------------------------------------------------------------------------
# artifact deltas
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def arts(replayed, boot):
    """(base, new) artifacts of the port and the same of the reference."""
    ru, tu = replayed
    rb = RS.StreamUpdater(boot["rs"].base, boot["rsk"], boot["params"],
                          MODEL, engine=RC.ClusterEngine())
    tb = TS.StreamUpdater(boot["ts"].base, boot["tsk"], boot["params"],
                          MODEL, engine=TC.ClusterEngine(device="cpu"))
    return (tb.export_artifact(), tu.export_artifact(),
            rb.export_artifact(), ru.export_artifact())


def test_artifact_delta_roundtrip(arts, tmp_path):
    base, new, rbase, rnew = arts
    assert base.content_id() == rbase.content_id()
    assert new.content_id() == rnew.content_id()
    delta = new.delta(base)
    want = rnew.delta(rbase)
    assert sorted(delta.changed) == sorted(want.changed)
    assert delta.removed == want.removed and delta.nbytes() == want.nbytes()
    assert any(k.startswith("sketch/") for k in delta.changed)
    assert any(k.startswith("edges/") for k in delta.changed)
    out = base.apply_delta(delta)
    assert out.content_id() == new.content_id()
    for key, arr in new._flat().items():
        assert np.array_equal(out._flat()[key], arr)
    with pytest.raises(ValueError, match="expects base"):
        new.apply_delta(delta)
    delta.save(str(tmp_path / "d0"))
    loaded = ArtifactDelta.load(str(tmp_path / "d0"))
    assert (loaded.base_id, loaded.new_id) == (delta.base_id, delta.new_id)
    assert base.apply_delta(loaded).content_id() == new.content_id()
    with pytest.raises(ValueError, match="not an ArtifactDelta"):
        new.save(str(tmp_path / "a"))
        ArtifactDelta.load(str(tmp_path / "a"))


def test_delta_crosses_packages(arts, tmp_path):
    base, new, rbase, rnew = arts
    new.delta(base).save(str(tmp_path / "port"))
    got = rbase.apply_delta(JaxDelta.load(str(tmp_path / "port")))
    assert got.content_id() == rnew.content_id()
    rnew.delta(rbase).save(str(tmp_path / "ref"))
    got = base.apply_delta(ArtifactDelta.load(str(tmp_path / "ref")))
    assert got.content_id() == new.content_id()
    assert isinstance(got, CompressedArtifact)
    # whole artifacts cross too
    new.save(str(tmp_path / "art"))
    assert JaxArtifact.load(str(tmp_path / "art")).content_id() == \
        rnew.content_id()


def test_delta_of_identical_artifact_is_empty(arts):
    new = arts[1]
    d = new.delta(new)
    assert d.changed == {} and d.removed == () and d.nbytes() == 0
    assert new.apply_delta(d).content_id() == new.content_id()


# ---------------------------------------------------------------------------
# the values chip_smoke.py pins (STREAM_REFERENCE)
# ---------------------------------------------------------------------------
def reference_stream_pins(stream_args: dict, d: int = 64) -> dict:
    """The reference's update-only replay of a stream: BACO (d, ratio
    0.25) on the warm prefix, then ``replay(updater, stream.steps, None,
    ReplayConfig(refresh_every=2, tune_steps=0))`` with the launcher's
    caps. Per step: adopted users and items, refresh sweeps and gamma,
    K_u and K_v, and the sha256 of the labels and the sketch's index
    arrays. Labels depend on the graph and the solver only, so the
    codebooks (zeros here) do not enter."""
    stream = RD.drifting_coclusters(**stream_args)
    engine = RC.ClusterEngine()
    sk = engine.build(stream.base, d=d, ratio=0.25)
    caps = caps_for(stream)
    params = {"user_table": np.zeros((sk.k_users, d), np.float32),
              "item_table": np.zeros((sk.k_items, d), np.float32)}
    up = RS.StreamUpdater(stream.base, sk, params, dict(MODEL, dim=d),
                          engine=engine, capacity=caps)
    rec = []
    apply_events, refresh = up.apply_events, up.refresh

    def apply_wrapped(*args):
        out = apply_events(*args)
        rec.append({"adopted_users": out["assign"].adopted_users,
                    "adopted_items": out["assign"].adopted_items})
        return out

    def refresh_wrapped(*args, **kwargs):
        stats = refresh(*args, **kwargs)
        rec[-1].update(sweeps=stats.iters, gamma=stats.gamma)
        return stats

    def close(line):
        rec[-1].update(k_users=up.sketch.k_users, k_items=up.sketch.k_items,
                       labels=sha(up.labels), user_idx=sha(up.sketch.user_idx),
                       item_idx=sha(up.sketch.item_idx))

    up.apply_events, up.refresh = apply_wrapped, refresh_wrapped
    RS.replay(up, stream.steps, None,
              RS.ReplayConfig(refresh_every=2, tune_steps=0), log=close)
    return {
        "stream": {"n_warm_users": stream.n_warm_users,
                   "n_warm_items": stream.n_warm_items,
                   "base_edges": stream.base.n_edges,
                   "total_edges": caps["n_edges"]},
        "bootstrap": {"k_users": sk.k_users, "k_items": sk.k_items,
                      "gamma": sk.meta["gamma"], "iters": sk.meta["iters"],
                      "labels": sha(sk.meta["joint_labels"]),
                      "user_idx": sha(sk.user_idx),
                      "item_idx": sha(sk.item_idx)},
        "steps": rec}


def test_reference_pins_are_the_ports_replay(boot):
    """The pin recipe at this module's size: the port's replay (cold
    assigns, capped refreshes, SCU) gives the reference's values."""
    want = reference_stream_pins(STREAM, d=D)
    stream = TD.drifting_coclusters(**STREAM)
    sk = boot["tsk"]
    assert want["bootstrap"]["labels"] == sha(sk.meta["joint_labels"])
    up = TS.StreamUpdater(stream.base, sk, boot["params"], MODEL,
                          engine=TC.ClusterEngine(device="cpu"),
                          capacity=caps_for(stream))
    got = []

    def close(line):
        got.append((sha(up.labels), sha(up.sketch.user_idx),
                    sha(up.sketch.item_idx)))

    TS.replay(up, stream.steps, None,
              TS.ReplayConfig(refresh_every=2, tune_steps=0), log=close)
    assert got == [(s["labels"], s["user_idx"], s["item_idx"])
                   for s in want["steps"]]


if __name__ == "__main__":
    # the chip smoke's stream: amazonbook's users, items and k_true
    args = dict(n_users=52_643, n_items=91_599, k_true=300, avg_deg=10, T=4,
                drift=0.05, seed=0)
    if len(sys.argv) > 1:
        args.update(json.loads(sys.argv[1]))
    print(json.dumps(reference_stream_pins(args), indent=1))

"""Hot-swap serving in the port, on the CPU.

A capacity-padded ``RecsysSession`` serves bitwise what an unpadded one
serves (fp32 and int8, dense and fused: the padding leaves every real
row's sums unchanged, and pad items carry -inf); ``swap`` copies a new
artifact into the session's tensors (every ``data_ptr`` kept, no state
allocated) and then serves what a fresh session over that artifact
serves, also when only the edges changed (the propagation's int32 ids
travel with the state); a swap past the rungs bumps the capacity and
still serves. The padded layout is the reference's except that the pad
edges lie outside every CSR segment. The reference's architecture rules
hold over ``src/repro_torch``, and ``python -m repro_torch.launch.stream
--device cpu`` replays a short stream. The module runs with one
intra-op thread (``one_thread``).
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import ClusterEngine
from repro_torch.data import drifting_coclusters
from repro_torch.models import lightgcn as L
from repro_torch.serve import CompressedArtifact, RecsysSession
from repro_torch.serve.session import _pad_state, capacity_plan
from repro_torch.stream import ReplayConfig, StreamUpdater, replay

STREAM = dict(n_users=600, n_items=480, k_true=12, avg_deg=10, T=3)
D = 16
K = 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many tiny ops, and several
    test processes share the machine; idle OpenMP threads spinning
    between ops would slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caps(stream):
    return {"n_users": stream.n_users, "n_items": stream.n_items,
            "k_users": stream.n_users // 2, "k_items": stream.n_items // 2,
            "n_edges": stream.base.n_edges
            + sum(s.edge_u.size for s in stream.steps)}


def _state_ptrs(session):
    return {f"{kind}/{k}": v.data_ptr()
            for kind, state in (("params", session.params),
                                ("statics", session.statics))
            for k, v in state.items()}


@pytest.fixture(scope="module")
def arts():
    """The bootstrap artifact and the export after each stream step
    (5 tune steps at each refresh, so codebooks change too)."""
    stream = drifting_coclusters(**STREAM)
    engine = ClusterEngine(device="cpu")
    sk = engine.build(stream.base, d=D, ratio=0.25)
    cfg = L.from_sketch(stream.base, sk, dim=D)
    params = L.init_params(0, cfg)
    up = StreamUpdater(stream.base, sk, params,
                       {"dim": D, "n_layers": 3, "l2": 1e-4,
                        "lookup_backend": None},
                       engine=engine, capacity=_caps(stream))
    out = [up.export_artifact()]
    export = up.export_artifact

    def record():
        art = export()
        out.append(art)
        return art

    up.export_artifact = record
    replay(up, stream.steps, None, ReplayConfig(refresh_every=2,
                                                tune_steps=5))
    return stream, out[:1] + out[2:]          # drop replay's own first


def _serve(session, ids):
    vals, items = session(ids)
    return vals.clone(), items.clone()


@pytest.mark.parametrize("scorer", ["dense", "fused"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_padded_session_equals_unpadded(arts, scorer, quantized):
    stream, seq = arts
    art = seq[-1].quantize() if quantized else seq[-1]
    ids = np.arange(0, art.model["n_users"], 7)
    exact = art.session(k=K, scorer=scorer, device="cpu")
    padded = art.session(k=K, scorer=scorer, capacity=_caps(stream),
                         device="cpu")
    assert padded.mcfg.n_items > art.model["n_items"]
    want, got = _serve(exact, ids), _serve(padded, ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[1].max()) < art.model["n_items"]       # no pad item


def test_swap_copies_in_place_and_allocates_nothing(arts):
    stream, seq = arts
    session = seq[0].session(k=K, scorer="fused", capacity=_caps(stream),
                             device="cpu")
    session.warmup(8)
    n_alloc, ptrs = session.state_allocations, _state_ptrs(session)
    assert n_alloc == len(ptrs) > 0
    ids = np.arange(0, stream.n_users, 11)
    for epoch, art in enumerate(seq[1:], 1):
        sw = session.swap(art)
        assert not sw["capacity_bumped"] and sw["state_allocations"] == 0
        assert session.state_allocations == n_alloc
        assert _state_ptrs(session) == ptrs
        assert session.swap_epoch == epoch
        assert session.artifact_id == art.content_id()
        fresh = art.session(k=K, scorer="fused", device="cpu")
        got, want = _serve(session, ids[ids < art.model["n_users"]]), \
            _serve(fresh, ids[ids < art.model["n_users"]])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    st = session.stats()
    assert st["capacity"] == session._caps
    assert st["stream"]["swaps"] == len(seq) - 1
    assert st["stream"]["capacity_bumps"] == 0
    assert st["state_allocations"] == n_alloc


def _rewired(art, shift):
    """``art`` with every edge (u, v) moved to (u, (v + shift) mod
    n_items): the same shapes, other edges and norms."""
    from repro_torch.core import BipartiteGraph
    n = art.model["n_items"]
    g = BipartiteGraph.from_edges(art.model["n_users"], n,
                                  art.edges["edge_u"],
                                  (art.edges["edge_v"] + shift) % n)
    assert g.n_edges == art.edges["edge_u"].size
    return CompressedArtifact(
        params=art.params,
        edges={"edge_u": g.edge_u, "edge_v": g.edge_v,
               "edge_norm": L.edge_norms(g)},
        sketch=art.sketch, model=art.model, provenance=art.provenance)


@pytest.mark.parametrize("padded", [False, True])
def test_swap_to_other_edges_serves_like_a_fresh_session(arts, padded):
    """Same shapes, other edges: the swap copies in place (same
    tensors), and the propagation must read the new edge ids."""
    stream, seq = arts
    art = seq[-1]
    other = _rewired(art, shift=7)
    caps = _caps(stream) if padded else None
    session = art.session(k=K, scorer="dense", capacity=caps, device="cpu")
    ids = np.arange(0, art.model["n_users"], 5)
    before = _serve(session, ids)
    ptrs = _state_ptrs(session)
    sw = session.swap(other)
    assert sw["state_allocations"] == 0 and _state_ptrs(session) == ptrs
    got = _serve(session, ids)
    want = _serve(other.session(k=K, scorer="dense", device="cpu"), ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[1], before[1])


def test_capacity_bump_counts_and_serves(arts):
    stream, seq = arts
    session = seq[0].session(k=K, capacity="auto", device="cpu")
    caps0 = dict(session._caps)
    n_alloc = session.state_allocations
    sw = session.swap(seq[-1])                     # outgrows the rungs
    assert sw["capacity_bumped"] and sw["capacity"] != caps0
    assert sw["state_allocations"] > 0
    assert session.state_allocations == n_alloc + sw["state_allocations"]
    assert session.telemetry.counters["capacity_bumps"] == 1
    ids = np.arange(0, stream.n_users, 13)
    got = _serve(session, ids)
    want = _serve(seq[-1].session(k=K, device="cpu"), ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_from_artifact_sets_the_reference_artifact_id(arts, tmp_path):
    from repro.serve import CompressedArtifact as JaxArtifact
    _, seq = arts
    seq[0].save(str(tmp_path / "a"))
    ref = JaxArtifact.load(str(tmp_path / "a"))
    session = RecsysSession.from_artifact(seq[0], k=K, device="cpu")
    assert session.artifact_id == ref.content_id() == seq[0].content_id()
    assert session.swap_epoch == 0
    session.swap(seq[1])
    session.swap(seq[2])
    assert session.swap_epoch == 2
    assert session.artifact_id == seq[2].content_id()
    assert RecsysSession(seq[0].params, seq[0].statics("cpu"),
                         seq[0].mcfg(), device="cpu").artifact_id is None


def test_pad_state_and_capacity_plan_match_the_reference(arts):
    """The padded state is the reference's, array for array, except
    that pad edges lie outside every CSR segment (indptr stays at the
    real edge count) and the int32 kernel ids ride along."""
    from repro.models import lightgcn as JL
    from repro.serve.session import _pad_state as jpad
    from repro.serve.session import capacity_plan as jplan
    stream, seq = arts
    art = seq[-1].quantize(keep_fp32=True)
    mcfg = art.mcfg()
    st = {k: v.numpy() for k, v in art.statics("cpu").items()}
    sj = JL.make_statics(_graph(art), None)
    sj.update(sketch_u=art.sketch.user_idx, sketch_v=art.sketch.item_idx)
    mj = JL.LightGCNConfig(**art.model)
    for hint in ({}, _caps(stream)):
        assert capacity_plan(mcfg, st, **hint) == jplan(mj, sj, **hint)
    caps = capacity_plan(mcfg, st, **_caps(stream))
    params = {**art.params, **art.quantized}
    p, s, m = _pad_state(params, st, mcfg, caps)
    pj, sj2, mjp = jpad(params, sj, mj, caps)
    assert (m.n_users, m.n_items, m.k_users, m.k_items) == \
        (mjp.n_users, mjp.n_items, mjp.k_users, mjp.k_items)
    for k in pj:
        assert p[k].dtype == pj[k].dtype and np.array_equal(p[k], pj[k]), k
    e = art.edges["edge_u"].size
    for k in sj2:
        want = np.asarray(sj2[k])
        if k.startswith("indptr"):
            n_real = art.model["n_users" if k == "indptr_u" else "n_items"]
            assert np.array_equal(s[k][:n_real + 1], want[:n_real + 1])
            assert (s[k][n_real:] == e).all() and want[-1] > e
        else:
            assert np.array_equal(s[k], want.astype(s[k].dtype)), k
    assert s["edge_v_idx32"].dtype == np.int32
    assert np.array_equal(s["edge_v_idx32"], s["edge_v"])
    with pytest.raises(ValueError, match="exceeds capacity"):
        _pad_state(params, st, mcfg, dict(caps, n_edges=8))


def _graph(art):
    from repro.core import BipartiteGraph as JaxGraph
    return JaxGraph.from_edges(art.model["n_users"], art.model["n_items"],
                               art.edges["edge_u"], art.edges["edge_v"])


def test_replay_swaps_serve_the_published_artifact():
    """replay() with a padded session and requests between steps: no
    swap allocates, and afterwards the session serves the final
    artifact as a fresh session does."""
    stream = drifting_coclusters(**dict(STREAM, seed=3))
    engine = ClusterEngine(device="cpu")
    sk = engine.build(stream.base, d=D, ratio=0.25)
    cfg = L.from_sketch(stream.base, sk, dim=D)
    model = {"dim": D, "n_layers": 3, "l2": 1e-4, "lookup_backend": None}
    up = StreamUpdater(stream.base, sk, L.init_params(1, cfg), model,
                       engine=engine, capacity=_caps(stream))
    session = up.export_artifact().session(k=K, scorer="fused",
                                           capacity=_caps(stream),
                                           device="cpu")
    n_alloc, ptrs = session.state_allocations, _state_ptrs(session)
    report = replay(up, stream.steps, session,
                    ReplayConfig(refresh_every=2, tune_steps=3,
                                 requests_per_step=2, request_batch=8))
    tele = report["telemetry"]
    assert tele["swaps"] == tele["appends"] == len(stream.steps)
    assert tele["capacity_bumps"] == 0 and tele["refreshes"] == 1
    assert session.state_allocations == n_alloc
    assert _state_ptrs(session) == ptrs
    assert session.stats()["requests"] == 2 * len(stream.steps)
    final = report["final_artifact"]
    assert session.artifact_id == final.content_id()
    ids = np.arange(0, stream.n_users, 9)
    got = _serve(session, ids)
    want = _serve(final.session(k=K, scorer="fused", device="cpu"), ids)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert set(report) == {
        "steps", "cold_assign_first_ms", "cold_assign_warm_p50_ms",
        "cold_assign_p50_ms", "cold_assign_total_ms", "refresh_total_ms",
        "tune_total_ms", "refresh_events_ms", "delta_bytes_mean",
        "telemetry", "final_artifact"}


# ---------------------------------------------------------------------------
# the reference's architecture rules, over the port
# ---------------------------------------------------------------------------
PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
GRAPH_MUTATION = re.compile(
    r"_from_sorted_keys|_merge_unique|_merge_disjoint|_fresh_mask"
    r"|_block_keys|\._cache\[")
SESSION_WRITE = re.compile(
    r"\b\w*(?:session|sess)\w*\.(?:params|statics)\s*=")


def _offenders(paths, pattern):
    out = []
    for path in paths:
        text = path.read_text()
        for m in pattern.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            out.append(f"{path}:{line}: {m.group(0)!r}")
    return out


def test_no_graph_surgery_outside_core_and_stream():
    paths = [p for p in PORT.rglob("*.py")
             if "core" not in p.parts and "stream" not in p.parts]
    paths.append(PORT.parents[1] / "chip_smoke.py")
    assert len(paths) > 20
    assert not _offenders(paths, GRAPH_MUTATION)
    assert _offenders([PORT / "stream" / "graph.py"], GRAPH_MUTATION)


def test_sessions_only_swap():
    paths = [p for p in PORT.rglob("*.py") if "serve" not in p.parts]
    paths.append(PORT.parents[1] / "chip_smoke.py")
    assert not _offenders(paths, SESSION_WRITE)


# ---------------------------------------------------------------------------
# the CLI and the default device
# ---------------------------------------------------------------------------
def test_stream_cli_replays_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import stream
    assert stream.main(["--device", "cpu", "--n-users", "300",
                        "--n-items", "240", "--k-true", "8", "--t-steps",
                        "2", "--steps", "10", "--tune-steps", "3",
                        "--dim", "8", "--requests-per-step", "2",
                        "--artifact", str(tmp_path / "final")]) == 0
    out = capsys.readouterr().out
    assert "step 0:" in out and "step 1:" in out and "refresh" in out
    assert "swap allocations=0" in out and "capacity_bumps': 0" in out
    assert CompressedArtifact.load(str(tmp_path / "final")).model[
        "n_users"] == 300


def test_stream_entry_points_default_to_cuda(monkeypatch, arts):
    from repro_torch.launch import stream as cli
    from repro_torch.stream import CapacityTuner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, seq = arts
    art = seq[0]
    calls = [
        lambda: cli.main(["--n-users", "300", "--n-items", "240"]),
        lambda: CapacityTuner({"dim": D}),
        lambda: StreamUpdater(None, art.sketch, art.params, art.model),
        lambda: art.session(capacity="auto"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

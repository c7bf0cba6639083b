"""The port's trace export, report and profiler bridge
(``repro_torch.obs``) against the JAX package's (``repro.obs``), and the
solver's spans.

  * The same spans export to the same JSONL lines, apart from the
    header's clock anchors; ``rollup``, ``render_trace`` and the
    ``obs_report`` CLI print the same text for one file in both packages.
  * Under ``device_annotations`` a live span opens a
    ``torch.profiler.record_function`` range; retroactive spans do not;
    the bridge is off by default.
  * ``cluster_solve`` nests ``lp_sweep`` and ``edge_block`` (the port's
    streamed solver at ``block_edges=200``), and ``fit_gamma`` nests its
    grid solves (``tests/test_obs.py:409-445`` on the port).
  * One clock: no raw ``perf_counter`` under ``src/repro_torch`` outside
    ``obs``.

A fixture installs a fresh global tracer and restores the previous one.
"""
from __future__ import annotations

import json
import os
import threading

import pytest
import torch

from repro.launch import obs_report as jreport_cli
from repro.obs import export as jexport
from repro.obs import report as jreport
from repro.obs.trace import Tracer as JaxTracer
from repro_torch.launch import obs_report as report_cli
from repro_torch.obs import (configure, export_jsonl, get_tracer,
                             set_tracer)
from repro_torch.obs import report
from repro_torch.obs.trace import Tracer

SRC_ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src", "repro_torch")


@pytest.fixture
def global_tracer():
    """Install a fresh enabled tracer as the process-global one and
    restore the previous object afterwards."""
    prev = get_tracer()
    t = set_tracer(Tracer(enabled=True))
    yield t
    set_tracer(prev)


# ---------------------------------------------------------------------------
# export and report: the reference's lines and text
# ---------------------------------------------------------------------------
def _record_spans(tracer, anchor: float, wall: float):
    """One request-shaped trace and one solver-shaped trace committed from
    fixed timestamps (both packages' ``record_span`` takes them as
    given)."""
    tracer.perf_t0, tracer.wall_t0 = anchor, wall
    t = anchor + 0.25
    req = tracer.record_span("request", t, t + 0.0045, tenant="web", n=7)
    tracer.record_span("admit", t, t + 0.00002, parent=req)
    q = tracer.record_span("queue", t + 0.00002, t + 0.0018, parent=req)
    b = tracer.record_span("batch", t + 0.0018, t + 0.0044, parent=req,
                           n_requests=2)
    tracer.record_span("dispatch", t + 0.0019, t + 0.0043, parent=b)
    tracer.record_span("device", t + 0.002, t + 0.0042, parent=b,
                       bucket=8, scorer="fused")
    s = tracer.record_span("cluster_solve", t + 1.0, t + 1.5,
                           solver="torch_streamed", n_nodes=110,
                           n_edges=300, gamma=0.7, iters=2)
    for i in range(2):
        sw = tracer.record_span("lp_sweep", t + 1.0 + 0.2 * i,
                                t + 1.15 + 0.2 * i, parent=s, sweep=i,
                                converged=bool(i))
        for blk in range(3):
            tracer.record_span("edge_block", t + 1.0 + 0.2 * i + 0.01 * blk,
                               t + 1.005 + 0.2 * i + 0.01 * blk,
                               parent=sw, block=blk)
    return q


def _both_files(tmp_path):
    """The same spans exported by each package: (port path, ref path)."""
    ours, theirs = Tracer(enabled=True), JaxTracer(enabled=True,
                                                   device_annotations=False)
    _record_spans(ours, 1000.0, 1.75e9)
    _record_spans(theirs, 1000.0, 1.75e9)
    paths = (str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl"))
    snap = {"frontdoor": {"responses": 4, "shed": 0}, "qps": 12.5}
    assert export_jsonl(ours, paths[0], metrics_snapshot=snap) == 15
    assert jexport.export_jsonl(theirs, paths[1],
                                metrics_snapshot=snap) == 15
    return paths


def test_same_spans_export_the_reference_lines(tmp_path):
    port, ref = _both_files(tmp_path)
    ours = [json.loads(x) for x in open(port)]
    theirs = [json.loads(x) for x in open(ref)]
    assert len(ours) == len(theirs) == 17
    head_o, head_t = ours[0], theirs[0]
    for key in ("wall_t0", "perf_t0"):
        head_o.pop(key)
        head_t.pop(key)
    assert head_o == head_t
    assert ours[1:] == theirs[1:]
    assert open(port).read().splitlines()[1:] \
        == open(ref).read().splitlines()[1:]


def test_export_of_live_spans_from_both_tracers(tmp_path):
    """Live spans: same names, ids, parents, attrs and line keys (times
    are each tracer's own)."""
    ours, theirs = Tracer(enabled=True), JaxTracer(enabled=True,
                                                   device_annotations=False)
    for tr in (ours, theirs):
        with tr.span("outer", k=1):
            with tr.span("inner"):
                pass
            tr.record_span("late", 0.0, 1.0, parent=tr.current())
    export_jsonl(ours, str(tmp_path / "a.jsonl"), drain=True)
    jexport.export_jsonl(theirs, str(tmp_path / "b.jsonl"), drain=True)
    a = [json.loads(x) for x in open(tmp_path / "a.jsonl")][1:]
    b = [json.loads(x) for x in open(tmp_path / "b.jsonl")][1:]
    strip = ("start_ms", "dur_ms", "wall_start")
    assert [{k: v for k, v in x.items() if k not in strip} for x in a] \
        == [{k: v for k, v in x.items() if k not in strip} for x in b]
    assert ours.spans() == [] and theirs.spans() == []


def test_rollup_and_trees_render_the_reference_text(tmp_path):
    port, ref = _both_files(tmp_path)
    ours, theirs = report.read_trace(port), jreport.read_trace(ref)
    assert ours["metrics"] == theirs["metrics"]
    spans = ours["spans"]
    assert report.rollup(spans) == jreport.rollup(theirs["spans"])
    assert report.render_rollup(spans) \
        == jreport.render_rollup(theirs["spans"])
    assert report.trace_ids(spans) == jreport.trace_ids(theirs["spans"]) \
        == ["t000001", "t000002"]
    for tid in ("t000001", "t000002", "t999999"):
        assert report.render_trace(spans, tid) \
            == jreport.render_trace(theirs["spans"], tid)
    assert report.render_metrics(ours["metrics"]) \
        == jreport.render_metrics(theirs["metrics"])
    assert "cluster_solve" in report.render_trace(spans, "t000002")


@pytest.mark.parametrize("argv", [[], ["--rollup"], ["--trace-id", "t000002"],
                                  ["--limit", "1"], ["--no-metrics"]],
                         ids=["all", "rollup", "one", "limit", "nometrics"])
def test_obs_report_cli_prints_the_reference_text(tmp_path, capsys, argv):
    port, _ = _both_files(tmp_path)
    assert report_cli.main([port, *argv]) == 0
    ours = capsys.readouterr().out
    assert jreport_cli.main([port, *argv]) == 0
    assert ours == capsys.readouterr().out


def test_obs_report_cli_fails_on_a_bad_file(tmp_path, capsys):
    empty = tmp_path / "empty.jsonl"
    empty.write_text(json.dumps({"kind": "header", "schema": 1}) + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text("{nope\n")
    for path in (empty, bad, tmp_path / "missing.jsonl"):
        assert report_cli.main([str(path)]) == 1
        assert report_cli.main([str(path)]) \
            == jreport_cli.main([str(path)])
    assert "obs_report:" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the torch.profiler bridge
# ---------------------------------------------------------------------------
def _profiled_names(tracer):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracer.span("bridge_outer"):
            with tracer.span("bridge_inner"):
                torch.ones(4).sum()
            tracer.record_span("bridge_late", 0.0, 1.0,
                               parent=tracer.current())
    return {e.name for e in prof.events()}


def test_profiler_bridge_opens_record_function_ranges():
    names = _profiled_names(Tracer(enabled=True, device_annotations=True))
    assert {"bridge_outer", "bridge_inner"} <= names
    assert "bridge_late" not in names          # retroactive: not bridged


def test_profiler_bridge_is_off_by_default():
    tracer = Tracer(enabled=True)
    assert not tracer.device_annotations
    names = _profiled_names(tracer)
    assert not names & {"bridge_outer", "bridge_inner", "bridge_late"}
    assert not get_tracer().device_annotations


def test_configure_mutates_global_in_place():
    prev = get_tracer()
    try:
        bound = set_tracer(Tracer(enabled=False))
        configure(enabled=True, sample_rate=0.5, max_spans=10,
                  device_annotations=True)
        assert bound.enabled and bound.sample_rate == 0.5
        assert bound.max_spans == 10 and bound.device_annotations
        configure(enabled=False)
        assert bound is get_tracer() and not bound.enabled
        assert bound.device_annotations          # None leaves it
    finally:
        set_tracer(prev)


def test_bridge_spans_cross_threads_like_the_reference(global_tracer):
    global_tracer.device_annotations = True
    out = {}

    def worker():
        with global_tracer.span("worker_root") as sp:
            out["trace"] = sp.trace_id

    th = threading.Thread(target=worker)
    th.start()
    th.join(timeout=30)
    assert not th.is_alive()
    names = [s.name for s in global_tracer.spans()]
    assert names == ["worker_root"] and out["trace"]


# ---------------------------------------------------------------------------
# the solver's spans (the port's versions of tests/test_obs.py:409-445)
# ---------------------------------------------------------------------------
def test_cluster_solve_emits_sweep_and_block_spans(global_tracer):
    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import planted_coclusters

    g, _, _ = planted_coclusters(60, 50, k_true=4, avg_deg=6, seed=0)
    wu, wv = make_weights(g, "hws")
    eng = ClusterEngine(solver="torch_streamed", block_edges=200,
                        device="cpu")
    eng.solve(g, wu, wv, 0.7, max_iters=2)
    spans = global_tracer.spans()
    names = [s.name for s in spans]
    assert "cluster_solve" in names
    assert "lp_sweep" in names
    assert "edge_block" in names
    solve = next(s for s in spans if s.name == "cluster_solve")
    assert solve.attrs["solver"] == "torch_streamed"
    assert {"n_nodes", "n_edges", "gamma", "iters"} <= set(solve.attrs)
    assert solve.attrs["n_nodes"] == g.n_nodes
    by_id = {s.span_id: s for s in spans}
    for s in spans:
        if s.name == "lp_sweep":
            assert by_id[s.parent_id].name == "cluster_solve"
        if s.name == "edge_block":
            assert by_id[s.parent_id].name == "lp_sweep"
    assert len({s.trace_id for s in spans}) == 1


def test_fit_gamma_nests_grid_solves(global_tracer):
    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import planted_coclusters

    g, _, _ = planted_coclusters(60, 50, k_true=4, avg_deg=6, seed=0)
    wu, wv = make_weights(g, "hws")
    eng = ClusterEngine(device="cpu")
    gamma, _, _ = eng.fit_gamma(g, wu, wv, budget=30, grid=4, max_iters=2)
    spans = global_tracer.spans()
    fit = [s for s in spans if s.name == "fit_gamma"]
    assert len(fit) == 1
    assert fit[0].attrs["gamma"] == gamma
    solves = [s for s in spans if s.name == "cluster_solve"]
    assert len(solves) >= 4
    assert all(s.parent_id == fit[0].span_id and
               s.trace_id == fit[0].trace_id for s in solves)


def test_solve_grid_emits_its_span(global_tracer):
    from repro_torch.core import ClusterEngine, make_weights
    from repro_torch.data import planted_coclusters

    g, _, _ = planted_coclusters(60, 50, k_true=4, avg_deg=6, seed=0)
    wu, wv = make_weights(g, "hws")
    with global_tracer.span("caller") as caller:
        ClusterEngine(device="cpu").solve_grid(g, wu, wv, [0.5, 2.0],
                                               max_iters=2)
    (grid,) = [s for s in global_tracer.spans()
               if s.name == "cluster_solve_grid"]
    assert grid.parent_id == caller.span_id
    assert grid.attrs == {"solver": "torch", "n_nodes": g.n_nodes,
                          "n_gammas": 2}


# ---------------------------------------------------------------------------
# one clock, owned by repro_torch.obs
# ---------------------------------------------------------------------------
def test_no_raw_perf_counter_outside_obs():
    """All latency bookkeeping in the port goes through
    ``repro_torch.obs.clock``, so every span and metric timestamp is
    comparable."""
    offenders = []
    for dirpath, _, files in os.walk(SRC_ROOT):
        rel = os.path.relpath(dirpath, SRC_ROOT)
        if rel == "obs" or rel.startswith("obs" + os.sep):
            continue
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as fh:
                for lineno, line in enumerate(fh, 1):
                    if "perf_counter" in line:
                        offenders.append(
                            f"{os.path.relpath(path, SRC_ROOT)}:{lineno}: "
                            f"{line.strip()}")
    assert not offenders, \
        "raw time.perf_counter() outside repro_torch/obs — use " \
        "repro_torch.obs.clock.now():\n" + "\n".join(offenders)

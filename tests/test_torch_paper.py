"""The paper's experiments on the port (``repro_torch.launch.paper``)
against the reference's ``benchmarks/`` modules, on the CPU at
``synth_xs`` (500 users, 400 items), d 64.

Tolerances, and why:
  * ``cluster_metrics``: exact (the same numpy on the same sketch).
  * ``sketch_for``: bitwise labels for table4's ``FAST_METHODS``
    (``full`` and ``baco_no_scu`` among them). ``scc`` calls
    ``scipy.sparse.linalg.svds`` without a start vector (ARPACK draws its
    own, and no numpy seed reaches it), so where two reference calls
    differ from each other the port is held to what the reference holds
    itself to: a sketch of the reference's row shapes, within the budget
    (as ``tests/test_torch_baselines.py`` does).
  * table5's ``_lp_sketch`` and table6's ``_variant``: bitwise, all four
    schemes and all four variants (the same solves and SCU/SCI); table5's
    full-size Louvain rows bitwise the reference's HWS sketch and its
    ``louvain_cpm_sketch`` (the reference's own CPM row raises).
  * fig4: the label count at each of the 8 iterations, exact.
  * fig2: its CLI's sweep (``--json --sizes``, into a store) gives the
    reference ``bench(sizes=[small])``'s ``kind``, ``n_nodes``,
    ``n_edges`` and ``iters`` for each solver (the reference's ``jax*``
    names mapped to ``torch*``) and the same gamma for each grid mode;
    the record's metrics are ``solve_metrics``' keys mapped one to one;
    ``parse_sizes`` raises the reference's errors.
  * ``train_eval`` and table9 start from the reference trainer's params,
    carried through a reference checkpoint (a fresh port trainer draws
    its params from numpy, the reference from a ``jax.random`` key), and
    train 20 steps: the ``params`` count exact, Recall@20 within 1e-6
    absolute, the distances within rtol 1e-5. NDCG@20 within 1e-6 for
    the uncompressed model. Not for the BACO model: items that share a
    codebook row and their neighbours tie in exact arithmetic, and each
    package's rounding orders them (ROADMAP Queue 3 #1; from one state
    with no step taken, NDCG differs by 2.5e-3 while Recall is equal).
    Its test holds instead every eval user's 20 best scores, rank by
    rank, within rtol 1e-5 (atol 1e-6 x the largest). The reference's
    propagation (``all_embeddings``) runs under one ``jax.jit``, in its
    evaluator too: called op by op it compiles ~130 programs.
  * Constants equal the reference's; the suite's ``MODULES`` are the
    reference's names, each mapped to a port module with a ``run``.
  * The suite in a subprocess (``--device cpu --only fig4_convergence``):
    exit 0 and one record; a second call reports ``cached``.
The module runs with one intra-op thread (``one_thread``), the
subprocess with ``OMP_NUM_THREADS=1``.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as ref_common
from benchmarks import fig1_balance_study as ref_fig1
from benchmarks import fig2_efficiency as ref_fig2
from benchmarks import fig4_convergence as ref_fig4
from benchmarks import run as ref_run
from benchmarks import table4_recall as ref_table4
from benchmarks import table5_weighting as ref_table5
from benchmarks import table6_scu as ref_table6
from benchmarks import table11_large_scale as ref_table11
from repro.core.baselines import _louvain_family as ref_louvain_family
from repro.core.baselines import louvain_cpm_sketch as ref_louvain_cpm
from repro.models import lightgcn as JL
from repro.training import Trainer as JaxTrainer

from repro_torch.core import ClusterEngine
from repro_torch.launch import cluster_scale
from repro_torch.launch.paper import common, fig2_efficiency, fig4_convergence
from repro_torch.launch.paper import fig1_balance_study, table4_recall
from repro_torch.launch.paper import run as suite
from repro_torch.launch.paper import table5_weighting, table6_scu
from repro_torch.launch.paper import table9_distance, table11_large_scale
from repro_torch.results import ResultsStore
from repro_torch.training import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
DS = "synth_xs"
STEPS = 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the trainers run thousands of tiny ops, and
    several test processes share the machine; idle OpenMP threads
    spinning between ops would slow every process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    _, _, _, train_j, test_j = ref_common.get_dataset(DS)
    _, _, _, train, test = common.get_dataset(DS)
    return train_j, test_j, train, test


def same_labels(a, b) -> bool:
    return (np.array_equal(a.user_idx, b.user_idx)
            and np.array_equal(a.item_idx, b.item_idx)
            and (a.k_users, a.k_items) == (b.k_users, b.k_items))


# ---------------------------------------------------------------------------
# sketches and cluster metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("method", ref_table4.FAST_METHODS)
def test_sketch_for_and_cluster_metrics(data, method):
    train_j, _, train, _ = data
    want = ref_common.sketch_for(method, train_j)
    got = common.sketch_for(method, train, device="cpu")
    if method == "full":
        assert want is None and got is None
        return
    if method == "scc" and not same_labels(
            want, ref_common.sketch_for(method, train_j)):
        # the reference differs from itself: a sketch of its shapes
        assert got.user_idx.shape == want.user_idx.shape
        assert got.item_idx.shape == want.item_idx.shape
        assert got.k_users + got.k_items <= int(0.25 * train.n_nodes)
    else:
        assert same_labels(got, want), method
    # the same sketch through both packages' cluster_metrics
    assert common.cluster_metrics(train, got) == \
        ref_common.cluster_metrics(train_j, got)


@pytest.mark.parametrize("scheme", table5_weighting.SCHEMES)
def test_table5_lp_sketch_is_bitwise(data, scheme):
    train_j, _, train, _ = data
    budget = int(0.25 * train.n_nodes)
    want = ref_table5._lp_sketch(train_j, scheme, budget)
    got = table5_weighting._lp_sketch(train, scheme, budget, "cpu")
    assert same_labels(got, want) and got.method == want.method


def test_table5_louvain_rows(data):
    """The full-size Louvain rows: HWS the reference's sketch; CPM
    ``louvain_cpm``'s, where the reference raises (Queue 3 #17)."""
    train_j, _, train, _ = data
    budget = int(0.25 * train.n_nodes)
    assert same_labels(table5_weighting._louvain_sketch(train, "hws", budget),
                       ref_louvain_family(train_j, budget, "hws", 1.0))
    with pytest.raises(TypeError):
        ref_louvain_family(train_j, budget, "cpm", None)
    assert same_labels(table5_weighting._louvain_sketch(train, "cpm", budget),
                       ref_louvain_cpm(train_j, budget))


@pytest.mark.parametrize("name,scu,sci", table6_scu.VARIANTS)
def test_table6_variant_is_bitwise(data, name, scu, sci):
    train_j, _, train, _ = data
    want = ref_table6._variant(train_j, scu, sci)
    got = table6_scu._variant(ClusterEngine(device="cpu"), train, scu, sci)
    assert same_labels(got, want) and got.method == want.method


# ---------------------------------------------------------------------------
# fig4 and fig2
# ---------------------------------------------------------------------------
def _k_by_row(rows):
    return [(name.split("/")[-1], dict(kv.split("=") for kv in d.split(";"))
             ["k"]) for name, _, d in rows]


def test_fig4_label_count_at_each_iteration(monkeypatch, capsys):
    monkeypatch.setattr(ref_fig4, "get_dataset",
                        lambda ds: ref_common.get_dataset(DS))
    monkeypatch.setattr(fig4_convergence, "get_dataset",
                        lambda ds: common.get_dataset(DS))
    want = _k_by_row(ref_fig4.run(fast=True))
    got = _k_by_row(fig4_convergence.run(fast=True, device="cpu"))
    assert len(got) == 8 and got == want


FIG2_SMALL = "300x240x8x6"


def test_fig2_bench_matches_the_reference(tmp_path, capsys):
    """The port's sweep through its CLI (``main --json --sizes``), into a
    store, against the reference's ``bench``."""
    want = ref_fig2.bench(sizes=ref_fig2.parse_sizes(FIG2_SMALL))
    store = str(tmp_path / "store")
    assert fig2_efficiency.main(["--json", "--sizes", FIG2_SMALL,
                                 "--device", "cpu", "--store", store]) == 0
    (rec,) = ResultsStore(store).records("cluster_solve")
    got = rec["payload"]["records"]
    names = fig2_efficiency.SOLVER_NAMES
    solve_keys = ("kind", "n_nodes", "n_edges", "iters")
    assert [{**{k: r[k] for k in solve_keys}, "solver": r["solver"]}
            for r in got if r["kind"] == "solve"] == \
        [{**{k: r[k] for k in solve_keys}, "solver": names[r["solver"]]}
         for r in want if r["kind"] == "solve"]
    grid = [(r["mode"], r["n_nodes"], r["gamma"]) for r in got
            if r["kind"] == "grid_search"]
    assert grid == [(r["mode"], r["n_nodes"], r["gamma"]) for r in want
                    if r["kind"] == "grid_search"]
    assert len({g for _, _, g in grid}) == 1       # the three modes agree

    def port_key(k):
        if not k.endswith("_solve_s"):
            return k
        return names[k[:-len("_solve_s")]] + "_solve_s"
    assert set(rec["metrics"]) == \
        {port_key(k) for k in ref_fig2.solve_metrics(want)}


@pytest.mark.parametrize("spec", ["1x2x3", "0x1x1x1", "2000x1500x24x12,",
                                  "ax1x1x1", "4x3x2x-1"])
def test_fig2_parse_sizes_raises_the_reference_errors(spec):
    with pytest.raises(ValueError) as want:
        ref_fig2.parse_sizes(spec)
    with pytest.raises(ValueError) as got:
        fig2_efficiency.parse_sizes(spec)
    assert str(got.value) == str(want.value)
    assert fig2_efficiency.parse_sizes("2x3x4x5,6x7x8x9") == \
        ref_fig2.parse_sizes("2x3x4x5,6x7x8x9")


# ---------------------------------------------------------------------------
# train_eval and table9, from the reference trainer's params
# ---------------------------------------------------------------------------
def _carried_runs(data, sketch, tmp_path, tag):
    """(reference metrics, reference trainer, port metrics, port trainer)
    of ``train_eval`` from one initial state: the reference train_eval's
    own trainer checkpoints its state when it is made, and the port
    train_eval's trainer restores it."""
    train_j, test_j, train, test = data
    jdir, pdir = tmp_path / f"jax_{tag}", tmp_path / f"port_{tag}"

    class Checkpointed(JaxTrainer):
        def __init__(self, graph, sk, cfg):
            super().__init__(graph, sk, dataclasses.replace(
                cfg, ckpt_dir=str(jdir)))
            self._maybe_checkpoint(force=True)
            shutil.copytree(jdir, pdir)

    class Resumed(Trainer):
        def __init__(self, graph, sk, cfg, device):
            super().__init__(graph, sk, dataclasses.replace(
                cfg, ckpt_dir=str(pdir)), device=device)
            assert self.maybe_resume() and self.step == 0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_common, "Trainer", Checkpointed)
        mp.setattr(common, "Trainer", Resumed)
        m_j, tr_j = ref_common.train_eval(train_j, sketch, test_j,
                                          steps=STEPS)
        m_t, tr_t = common.train_eval(train, sketch, test, steps=STEPS,
                                      device="cpu")
    return m_j, tr_j, m_t, tr_t


# the reference's propagation under one jit: its evaluator calls it op
# by op, ~130 compiles on the first call (~9 s here)
_ref_all_embeddings = jax.jit(JL.all_embeddings, static_argnums=2)


def _ref_eval_embeddings(params, statics, cfg, user_ids):
    u_all, v_all = _ref_all_embeddings(params, statics, cfg)
    return u_all[user_ids], v_all


@pytest.fixture(scope="module")
def carried(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("carried")
    sk = common.sketch_for("baco", data[2], device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "eval_embeddings", _ref_eval_embeddings)
        return {"full": _carried_runs(data, None, tmp, "full"),
                "baco": _carried_runs(data, sk, tmp, "baco")}


def _ref_embeddings(tr):
    return tuple(np.asarray(a) for a in _ref_all_embeddings(
        tr.params, tr.statics, tr.mcfg))


def _top20_scores(u, v, graph, users):
    """Each eval user's 20 best scores over the items it has not
    trained on, best first."""
    s = u[users] @ v.T
    keep = np.isin(graph.edge_u, users)
    s[np.searchsorted(users, graph.edge_u[keep]), graph.edge_v[keep]] = \
        -np.inf
    return -np.sort(-s, axis=1)[:, :20]


@pytest.mark.parametrize("method", ["full", "baco"])
def test_train_eval_from_the_reference_state(data, carried, method):
    m_j, tr_j, m_t, tr_t = carried[method]
    assert m_t["params"] == m_j["params"]
    assert m_t["n_users"] == m_j["n_users"] > 0
    assert abs(m_t["recall"] - m_j["recall"]) <= 1e-6
    assert m_t["train_s"] > 0
    if method == "full":
        assert abs(m_t["ndcg"] - m_j["ndcg"]) <= 1e-6
        return
    # items that share a codebook row and their neighbours tie in exact
    # arithmetic; each package's rounding orders them (ROADMAP Queue 3
    # #1), which moves NDCG, not the scores at each rank
    users = np.unique(data[3][0])
    want = _top20_scores(*_ref_embeddings(tr_j), data[2], users)
    got = _top20_scores(*table9_distance.embeddings(tr_t), data[2], users)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_table9_distances_from_the_reference_state(carried):
    _, full_j, _, full_t = carried["full"]
    _, tr_j, _, tr_t = carried["baco"]
    # the reference's table9 arithmetic on the reference's trainers
    u_full, v_full = _ref_embeddings(full_j)
    u, v = _ref_embeddings(tr_j)
    du = float(np.linalg.norm(u - u_full, axis=1).mean())
    dv = float(np.linalg.norm(v - v_full, axis=1).mean())
    n = u.shape[0] + v.shape[0]
    want = {"dist_user": du, "dist_item": dv,
            "dist_all": (du * u.shape[0] + dv * v.shape[0]) / n}
    got = table9_distance.distances(*table9_distance.embeddings(tr_t),
                                    *table9_distance.embeddings(full_t))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# constants, the suite's modules and the CPU runs
# ---------------------------------------------------------------------------
def test_constants_equal_the_reference():
    assert table4_recall.FAST_METHODS == ref_table4.FAST_METHODS
    assert table4_recall.FULL_METHODS == ref_table4.FULL_METHODS
    assert fig1_balance_study.METHODS == ref_fig1.METHODS
    assert fig2_efficiency.SIZES_FAST == ref_fig2.SIZES_FAST
    assert fig2_efficiency.SIZES_FULL == ref_fig2.SIZES_FULL
    assert fig2_efficiency.NUMPY_MAX_NODES == ref_fig2.NUMPY_MAX_NODES
    assert fig2_efficiency.GAMMA == ref_fig2.GAMMA
    assert table11_large_scale.SCC_FIT_SIZES == ref_table11.SCC_FIT_SIZES
    assert suite.MODULES == ref_run.MODULES
    for name in suite.MODULES:
        assert callable(importlib.import_module(suite.module_path(name)).run)


def test_cluster_scale_run_gives_the_reference_rows(monkeypatch, capsys):
    monkeypatch.setitem(cluster_scale.RUNGS, "10k", (300, 240, 8))
    rows = cluster_scale.run(fast=True, device="cpu")
    assert [r[0] for r in rows] == ["cluster_scale/10k/streamed",
                                    "cluster_scale/10k/cold_minhash"]
    derived = dict(kv.split("=") for kv in rows[0][2].split(";"))
    assert set(derived) == {"sweeps", "blocks_per_s", "peak_mb", "bitwise"}
    assert derived["bitwise"] == "True"


def test_suite_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        suite.main(["--only", "fig4_convergence", "--no-store"])


def test_suite_cli_records_once_then_reports_cached(tmp_path, capsys):
    store = str(tmp_path / "store")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    argv = ["--device", "cpu", "--only", "fig4_convergence", "--store",
            store]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.paper.run",
                        *argv], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "fig4/gowalla_s/iter8," in r.stdout
    assert "# fig4_convergence done in" in r.stdout
    (rec,) = ResultsStore(store).records("suite")
    assert rec["payload"]["module"] == "fig4_convergence"
    assert len(rec["payload"]["rows"]) == 8
    assert rec["metrics"]["wall_s"]["higher_is_better"] is False
    assert suite.main(argv) == 0
    assert "# fig4_convergence cached" in capsys.readouterr().out
    assert len(ResultsStore(store).records("suite")) == 1


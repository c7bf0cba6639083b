"""The port's benches (``repro_torch.launch.*_bench``, ``cluster_scale``,
``roofline``) against the reference's (``benchmarks/``), and the
``host_seed`` trainer backend against ``repro``'s.

  * Every headline-metric function equals the reference's exactly on the
    same record dicts: the payloads of the reference's committed store
    (``results_store/``, read only) and hand-made rows; on the port's
    renamed columns (``state_allocations`` for ``compiles``,
    ``speedup_vs_dense`` for ``speedup_vs_dense_xla``) the metric takes
    the port's name.
  * Each bench's config dict hashes equal to the reference's for the same
    arguments (both mains stopped at their cache lookup).
  * Each bench's ``main`` on the CPU at a tiny size appends one record
    with declared directions to a store under ``tmp_path``; a second call
    replays and appends nothing, ``--force`` appends.
  * ``host_seed``: loss and gradients equal the reference's
    ``bpr_loss_fn_seed`` within rtol 1e-5 / atol 1e-6 (gradients atol
    1e-6 of their largest entry) on ``tests/test_torch_train.py``'s small
    graph, without the CSR gather-sum kernel; 5 ``host_seed`` trainer
    steps from one shared checkpoint track the reference's losses within
    rtol 1e-5.
"""
from __future__ import annotations

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import cluster_scale_bench as j_scale
from benchmarks import kernel_bench as j_kernel
from benchmarks import load_bench as j_load
from benchmarks import roofline as j_roofline
from benchmarks import serve_bench as j_serve
from benchmarks import stream_bench as j_stream
from benchmarks import train_bench as j_train
from repro import results as jres
from repro.core import Sketch as JaxSketch
from repro.data import planted_coclusters as jax_planted
from repro.models import lightgcn as JL
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import Trainer as JaxTrainer
from repro_torch import results as res
from repro_torch.core import ClusterEngine
from repro_torch.data import BPRSampler, planted_coclusters
from repro_torch.launch import (cluster_scale, kernel_bench, load_bench,
                                roofline, serve_bench, stream_bench,
                                train_bench)
from repro_torch.models import lightgcn as L
from repro_torch.results import ResultsStore
from repro_torch.training import TrainConfig, Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 16


@pytest.fixture(autouse=True)
def no_default_store(monkeypatch, tmp_path):
    """A run that forgets --store writes under tmp_path, never into the
    checkout."""
    monkeypatch.setenv("REPRO_TORCH_RESULTS_STORE",
                       str(tmp_path / "default_store"))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# headline metrics: the reference's functions on the same dicts
# ---------------------------------------------------------------------------
def _committed_payloads(bench: str) -> list:
    """Payloads of the reference's committed store shard (imported
    records keep theirs under config.legacy)."""
    out = []
    with open(os.path.join(REPO, "results_store", f"{bench}.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if "op" in rec:
                continue
            out.append(rec.get("payload") or rec["config"]["legacy"])
    assert out, bench
    return out


_ERR = {"backend": "x", "chunk": 1, "error": "boom"}
HAND_TRAIN = [[], [_ERR], [{"backend": "host", "chunk": 1,
                            "steps_per_s": 3.0, "speedup_vs_seed": 2.5},
                           _ERR, "not a row"]]
HAND_SERVE = [[], [{"backend": "x", "error": "boom"}],
              [{"backend": "auto", "bucket": 1, "p50_ms": 2.0,
                "p99_ms": 3.0, "compiles": 3},
               {"backend": "gather", "bucket": 8, "p50_ms": 1.0,
                "p99_ms": 4.0}]]
HAND_STREAM = [{}, {"swap_p99_ms": float("nan"), "recall_stream": 0.4,
                    "compiles": True, "capacity_bumps": 0},
               {"recall_full": 1, "maintenance_frac_of_full": "x"}]
HAND_SERVER = [{}, {"sustained_qps": 120.5, "shed": 0, "failed": False,
                    "compiles_under_load": 2, "swap_pause_ms": None}]
HAND_LADDER = [[], ["x", {"rung": "10k", "sweep_ms": 2.0,
                          "bitwise_equal_inmem": False,
                          "cold": {"minhash_recall": 0.9}},
                    {"rung": "1m", "peak_device_bytes": 123456789,
                     "blocks_per_s": 7.5, "bitwise_equal_inmem": True}]]


def _kernel_sweeps():
    sweeps = [(p["codebook_lookup"], p["fused"])
              for p in _committed_payloads("kernel")]
    sweeps.append(([{"backend": "x", "error": "e"}],
                   [{"variant": "fused", "error": "k cap"},
                    {"variant": "fused_cb", "B": 4, "N": 8, "d": 2,
                     "K": 2, "us_per_call": 2.0, "bytes_moved": 2000,
                     "achieved_gbps": 1.0, "speedup_vs_dense_xla": 3.0}]))
    return sweeps


def _metric_cases():
    cases = []
    for p in _committed_payloads("train_pipeline"):
        cases.append(("train", p["records"]))
    cases += [("train", rows) for rows in HAND_TRAIN]
    for p in _committed_payloads("serve_session"):
        cases.append(("serve", p["records"]))
    cases += [("serve", rows) for rows in HAND_SERVE]
    cases += [("stream", p) for p in _committed_payloads("stream")]
    cases += [("stream", p) for p in HAND_STREAM]
    cases += [("server", p) for p in _committed_payloads("server")]
    cases += [("server", p) for p in HAND_SERVER]
    cases += [("ladder", p["rungs"])
              for p in _committed_payloads("cluster_scale")]
    cases += [("ladder", rows) for rows in HAND_LADDER]
    cases += [("sweep", s) for s in _kernel_sweeps()]
    cases += [("serving", j_roofline.serving_roofline(f))
              for _, f in _kernel_sweeps()]
    return cases


METRIC_FNS = {
    "train": (train_bench.pipeline_metrics, j_train.pipeline_metrics),
    "serve": (serve_bench.session_metrics, j_serve.session_metrics),
    "stream": (stream_bench.stream_metrics, j_stream.stream_metrics),
    "server": (load_bench.server_metrics, j_load.server_metrics),
    "ladder": (cluster_scale.ladder_metrics, j_scale.ladder_metrics),
    "sweep": (lambda s: kernel_bench.sweep_metrics(*s),
              lambda s: j_kernel.sweep_metrics(*s)),
    "serving": (roofline.serving_metrics, j_roofline.serving_metrics),
}
CASES = _metric_cases()


@pytest.mark.parametrize("kind,dicts", CASES,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(CASES)])
def test_headline_metrics_equal_the_reference(kind, dicts):
    ours, theirs = METRIC_FNS[kind]
    got, want = ours(dicts), theirs(dicts)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got == want or any(m["value"] != m["value"]
                              for m in got.values())


def test_renamed_columns_give_the_ports_metric_names():
    rows = [{"backend": "auto", "scorer": "fused", "bucket": 1,
             "p50_ms": 1.0, "p99_ms": 2.0, "state_allocations": 13}]
    assert serve_bench.session_metrics(rows)["max_state_allocations"] == \
        res.lower(13)
    assert "max_compiles" not in serve_bench.session_metrics(rows)
    fused = [{"variant": "fused", "us_per_call": 2.0, "achieved_gbps": 1.0,
              "speedup_vs_dense": 4.0}]
    m = kernel_bench.sweep_metrics([], fused)
    assert m["best_speedup_vs_dense"] == res.higher(4.0)
    assert "best_speedup_vs_dense_xla" not in m
    assert stream_bench.stream_metrics({"swap_state_allocations": 0}) == \
        {"swap_state_allocations": res.lower(0)}
    assert load_bench.server_metrics(
        {"state_allocations_under_load": 0}) == \
        {"state_allocations_under_load": res.lower(0)}


def test_serving_roofline_takes_the_larger_bound():
    rows = roofline.serving_roofline([
        # memory-bound: B = 1 against 91,599 items
        {"variant": "fused", "B": 1, "N": 91599, "d": 64, "K": 20,
         "us_per_call": 62.69, "bytes_moved": 1 * 64 * 4 + 160
         + 91599 * 64 * 4},
        # bounded by operations: B = 512 (2 B N d = 6.0e9 at 67 TFLOP/s)
        {"variant": "fused", "B": 512, "N": 91599, "d": 64, "K": 20,
         "us_per_call": 389.3, "bytes_moved": 512 * 64 * 4 + 512 * 160
         + 91599 * 64 * 4},
        {"variant": "fused_cb", "B": 64, "N": 2048, "d": 64, "K": 20,
         "H": 2, "us_per_call": 10.0, "bytes_moved": 10},
        {"variant": "fused", "error": "k cap"}])
    assert rows[0]["bound_by"] == "bytes"
    assert rows[0]["bound_us"] == pytest.approx(
        (91599 * 64 * 4 + 416) / 3.35e12 * 1e6, rel=1e-3)
    assert rows[1]["bound_by"] == "operations"
    assert rows[1]["bound_ms"] == pytest.approx(0.0896, abs=1e-4)
    assert rows[1]["roofline_frac"] == pytest.approx(
        rows[1]["bound_us"] / 389.3, rel=1e-4)
    nbytes = 512 * 64 * 4 + 512 * 160 + 91599 * 64 * 4
    assert rows[1]["hbm_frac"] == pytest.approx(
        nbytes / 389.3e-6 / 3.35e12, rel=1e-4)
    assert rows[2]["ops_us"] == pytest.approx(
        (2 * 64 * 2048 * 64 + 2048 * 64) / 67e12 * 1e6, rel=1e-3)
    assert rows[3] == {"variant": "fused", "error": "k cap"}


# ---------------------------------------------------------------------------
# config dicts: the reference's hash for the same arguments
# ---------------------------------------------------------------------------
def _captured_hash(monkeypatch, cls, main, argv) -> str:
    seen = []

    def cached(self, config):
        seen.append(res.config_hash(self.bench, config))
        return {"config_hash": seen[-1], "payload": {}, "created_at": "-"}

    monkeypatch.setattr(cls, "cached", cached)
    assert main(argv) == 0
    assert len(seen) == 1
    return seen[0]


STREAM_SMOKE = ["--n-users", "52643", "--n-items", "91599", "--k-true",
                "300", "--dim", "64"]
HASH_CASES = [
    ("train", []), ("train", ["--dataset", "amazonbook", "--dim", "64",
                              "--batch", "2048"]),
    ("serve", []), ("serve", ["--dataset", "amazonbook", "--dim", "64"]),
    ("stream", []), ("stream", STREAM_SMOKE + ["--drift", "0.08"]),
    ("load", []), ("load", ["--dataset", "amazonbook", "--dim", "64",
                            "--qps", "120", "--duration", "4",
                            "--deadline-ms", "50"]),
    ("scale", []), ("scale", ["--rungs", "100k"]),
    ("scale", ["--rungs", "10k,1m", "--block-edges", "4096"]),
    ("kernel", ["--json"]), ("kernel", ["--json", "--full"]),
    # sample counts above the benches' defaults
    ("train", ["--dataset", "amazonbook", "--dim", "64", "--batch", "2048",
               "--rounds", "10"]),
    ("serve", ["--dataset", "amazonbook", "--dim", "64", "--n-requests",
               "200"]),
    ("stream", STREAM_SMOKE + ["--steps", "32", "--drift", "0.0064"]),
]
MAINS = {"train": (train_bench.main, j_train.main),
         "serve": (serve_bench.main, j_serve.main),
         "stream": (stream_bench.main, j_stream.main),
         "load": (load_bench.main, j_load.main),
         "scale": (cluster_scale.main, j_scale.main),
         "kernel": (kernel_bench.main, j_kernel.main)}


@pytest.mark.parametrize("name,argv", HASH_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(HASH_CASES)])
def test_config_hash_equals_the_reference_for_the_same_arguments(
        monkeypatch, capsys, name, argv):
    ours, theirs = MAINS[name]
    want = _captured_hash(monkeypatch, jres.BenchRun, theirs, list(argv))
    got = _captured_hash(monkeypatch, res.BenchRun, ours,
                         list(argv) + ["--device", "cpu", "--no-store"])
    assert got == want
    capsys.readouterr()


def test_kernel_bench_repeats_is_in_the_config(monkeypatch, capsys,
                                               tmp_path,
                                               small_kernel_shapes):
    """``--repeats 3`` is the reference's fixed count (the hash of no
    flag, which equals the reference's: ``HASH_CASES``); another count
    is another configuration, and every sweep row is timed over it."""
    base = ["--json", "--device", "cpu", "--no-store"]
    with monkeypatch.context() as m:
        want = _captured_hash(m, res.BenchRun, kernel_bench.main, base)
    with monkeypatch.context() as m:
        assert _captured_hash(m, res.BenchRun, kernel_bench.main,
                              base + ["--repeats", "3"]) == want
        assert _captured_hash(m, res.BenchRun, kernel_bench.main,
                              base + ["--repeats", "7"]) != want
    seen = []
    real = kernel_bench._time_us
    monkeypatch.setattr(kernel_bench, "_time_us", lambda fn, dev, r=1: (
        seen.append(r), real(fn, dev, r))[1])
    store_dir = str(tmp_path / "store")
    assert kernel_bench.main(["--device", "cpu", "--store", store_dir,
                              "--json", "--repeats", "7"]) == 0
    (rec,) = ResultsStore(store_dir).records("kernel")
    assert rec["payload"]["config"]["repeats"] == 7
    assert seen and set(seen) == {7}
    capsys.readouterr()


def _chip_smoke():
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_counts_cap_refusals_apart_from_failures():
    """chip_smoke.py's ``bench_errors``: a kernel-bench fused row refused
    for a k above the kernels' cap is a refusal, reported and counted;
    any other error row is a failure."""
    cs = _chip_smoke()
    refused = {"variant": "fused", "B": 256, "N": 16384, "d": 64,
               "K": 100, "error": "fused_topk takes 1 <= k <= 32, got "
                                  "k=100", "error_type": "ValueError"}
    other = {"variant": "fused_int8", "B": 64, "N": 4096, "d": 64,
             "K": 20, "error": "fused_topk takes d <= 32, got d=64"}
    ok = {"variant": "dense", "B": 64, "us_per_call": 1.0}
    bad, ref = cs.bench_errors("kernel", {"codebook_lookup": [ok],
                                          "fused": [ok, refused, other]})
    assert bad == [other]
    assert ref == [{k: refused[k] for k in ("variant", "B", "N", "d", "K",
                                            "error")}]
    assert cs.bench_errors("kernel", {"codebook_lookup": [other],
                                      "fused": []}) == ([other], [])
    rows = [{"backend": "auto", "p50_ms": 1.0}, {"backend": "x",
                                                  "error": "E"}]
    assert cs.bench_errors("serve_session", {"records": rows}) == (
        rows[1:], [])


# ---------------------------------------------------------------------------
# each bench end to end on the CPU, into a temporary store
# ---------------------------------------------------------------------------
TINY = {
    "train_pipeline": (train_bench.main, ["--dim", "8", "--batch", "64",
                                          "--steps", "4", "--rounds", "2"]),
    "serve_session": (serve_bench.main, ["--dataset", "synth_xs", "--dim",
                                         "8", "--steps", "4",
                                         "--n-requests", "3"]),
    "stream": (stream_bench.main, ["--n-users", "300", "--n-items", "240",
                                   "--k-true", "6", "--dim", "8",
                                   "--base-steps", "10", "--full-steps",
                                   "10", "--tune-steps", "4"]),
    "server": (load_bench.main, ["--dataset", "synth_xs", "--dim", "8",
                                 "--steps", "5", "--extra-steps", "2",
                                 "--qps", "20", "--duration", "0.5"]),
    "cluster_scale": (cluster_scale.main, ["--rungs", "10k"]),
    "kernel": (kernel_bench.main, ["--json"]),
}
ERROR_METRIC = {"train_pipeline": "train_errors",
                "serve_session": "serve_errors", "kernel": "lookup_errors",
                "server": "failed"}


@pytest.fixture
def small_kernel_shapes(monkeypatch):
    monkeypatch.setattr(kernel_bench, "SWEEP_SHAPES", [(16, 64, 8, 2)])
    monkeypatch.setattr(kernel_bench, "FUSED_SHAPES", [(4, 300, 8, 5)])
    monkeypatch.setattr(kernel_bench, "FUSED_CB_SHAPE",
                        (4, 200, 8, 5, 30, 2))


@pytest.mark.parametrize("bench", list(TINY))
def test_bench_appends_one_record_with_declared_directions(
        tmp_path, capsys, small_kernel_shapes, bench):
    main, argv = TINY[bench]
    store_dir = str(tmp_path / "store")
    assert main(["--device", "cpu", "--store", store_dir, *argv]) == 0
    recs = ResultsStore(store_dir).records(bench)
    assert len(recs) == 1
    (rec,) = recs
    assert rec["bench"] == bench and rec["payload"]["bench"] == bench
    assert rec["fingerprint_key"] == f"cpu:cpu:1:torch{torch.__version__}"
    assert rec["metrics"]
    for name, m in rec["metrics"].items():
        assert isinstance(m["higher_is_better"], bool), name
    if bench in ERROR_METRIC:
        assert rec["metrics"][ERROR_METRIC[bench]]["value"] == 0
    capsys.readouterr()


def test_cached_replays_and_force_appends(tmp_path, capsys,
                                          small_kernel_shapes):
    store_dir = str(tmp_path / "store")
    argv = ["--device", "cpu", "--store", store_dir, "--json"]
    assert kernel_bench.main(argv) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert kernel_bench.main(argv) == 0
    out = capsys.readouterr()
    assert "cached" in out.err
    assert json.loads(out.out.strip().splitlines()[-1]) == first
    assert len(ResultsStore(store_dir).records("kernel")) == 1
    assert kernel_bench.main(argv + ["--force"]) == 0
    assert len(ResultsStore(store_dir).records("kernel")) == 2
    # the serving roofline of the newest kernel record, into the store
    assert roofline.main(["--device", "cpu", "--store", store_dir,
                          "--serving", "store", "--json"]) == 0
    (rec,) = ResultsStore(store_dir).records("roofline_serving")
    rows = rec["payload"]["rows"]
    assert len(rows) == rec["metrics"]["roofline_rows"]["value"] == 6
    assert {r["bound_by"] for r in rows} <= {"bytes", "operations"}
    assert all(r["bound_us"] == max(r["bytes_us"], r["ops_us"])
               for r in rows)
    assert "NOTE: record was produced on 'cpu'" in capsys.readouterr().out


def test_train_bench_rows_cover_every_backend(tmp_path, capsys):
    main, argv = TINY["train_pipeline"]
    store_dir = str(tmp_path / "store")
    assert main(["--device", "cpu", "--store", store_dir, "--json",
                 *argv]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = [(r["backend"], r["chunk"]) for r in payload["records"]]
    assert keys == [("host_seed", 1), ("host", 1), ("fused", 1),
                    ("fused", 8), ("fused", 32), ("fused_sharded", 1),
                    ("fused_sharded", 8), ("fused_sharded", 32)]
    seed_row = payload["records"][0]
    assert seed_row["speedup_vs_seed"] == 1.0
    assert all(r["steps_per_s"] > 0 for r in payload["records"])


# ---------------------------------------------------------------------------
# host_seed: the reference's frozen seed step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    gj, _, _ = jax_planted(300, 240, 10, 8, seed=2)
    gt, _, _ = planted_coclusters(300, 240, 10, 8, seed=2)
    sk = ClusterEngine(device="cpu").build(gt, d=D, ratio=0.3)
    sk_j = JaxSketch(sk.user_idx, sk.item_idx, sk.k_users, sk.k_items,
                     method=sk.method, meta=sk.meta)
    return gj, gt, sk, sk_j


@pytest.mark.parametrize("compressed", [False, True], ids=["full", "sketch"])
def test_seed_loss_and_grads_match_the_reference(setup, compressed,
                                                 monkeypatch):
    gj, gt, sk, sk_j = setup
    cfg = L.from_sketch(gt, sk if compressed else None, dim=D, n_layers=3)
    cfg_j = JL.from_sketch(gj, sk_j if compressed else None, dim=D,
                           n_layers=3)
    params = L.init_params(7, cfg)
    u, p, n = BPRSampler(gt, 128, seed=3).next_batch()
    js = JL.make_statics(gj, sk_j if compressed else None)
    jb = {"user": jnp.asarray(u), "pos": jnp.asarray(p),
          "neg": jnp.asarray(n)}
    want, want_g = jax.jit(jax.value_and_grad(
        lambda q: JL.bpr_loss_fn_seed(q, js, jb, cfg_j)))(
        {k: jnp.asarray(v) for k, v in params.items()})

    def no_kernel(*a, **kw):
        raise AssertionError("the seed step must not reach the CSR "
                             "gather-sum")

    monkeypatch.setattr(L, "csr_gather_sum", no_kernel)
    tp = {k: torch.as_tensor(v).requires_grad_(True)
          for k, v in params.items()}
    ts = L.make_statics(gt, sk if compressed else None, device="cpu")
    tb = {"user": torch.as_tensor(u), "pos": torch.as_tensor(p),
          "neg": torch.as_tensor(n)}
    loss = L.bpr_loss_fn_seed(tp, ts, tb, cfg)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=1e-5, atol=1e-6)
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names])
    for name, g in zip(names, grads):
        w = np.asarray(want_g[name])
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * np.abs(w).max())


def test_seed_propagation_matches_the_scatter_free_one(setup):
    _, gt, sk, _ = setup
    cfg = L.from_sketch(gt, sk, dim=D, n_layers=3)
    params = {k: torch.as_tensor(v) for k, v in L.init_params(1, cfg).items()}
    statics = L.make_statics(gt, sk, device="cpu")
    for got, want in zip(L.all_embeddings_seed(params, statics, cfg),
                         L.all_embeddings(params, statics, cfg)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _cfg(**kw):
    base = dict(dim=D, n_layers=3, lr=5e-3, batch_size=128, steps=5,
                seed=0, ckpt_every=1000)
    base.update(kw)
    return base


@pytest.mark.parametrize("compressed", [True, False], ids=["sketch", "full"])
def test_host_seed_trainer_tracks_the_reference(setup, tmp_path, compressed):
    gj, gt, sk, sk_j = setup
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt = JaxTrainer(gj, sk_j if compressed else None, JaxTrainConfig(
        **_cfg(backend="host_seed", sampler="numpy", ckpt_dir=jdir)))
    jt._maybe_checkpoint(force=True)                 # the shared state
    shutil.copytree(jdir, pdir)
    pt = Trainer(gt, sk if compressed else None, TrainConfig(
        **_cfg(backend="host_seed", sampler="numpy", ckpt_dir=pdir)),
        device="cpu")
    assert pt.backend.name == "host_seed"
    assert pt.maybe_resume() and pt.step == 0
    want = jt.run(log_every=0)
    got = pt.run(log_every=0)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_host_seed_is_never_the_default(setup):
    _, gt, sk, _ = setup
    assert Trainer(gt, sk, TrainConfig(**_cfg()),
                   device="cpu").backend.name == "host"
    assert TrainConfig().backend is None

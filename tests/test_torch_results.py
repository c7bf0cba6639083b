"""The port's results store, BenchRun and regression gate
(``repro_torch.results``) against the JAX package's (``repro.results``).

The cases of ``tests/test_results_store.py`` that do not need the
reference's legacy importer, on the port's copy; then the two packages
side by side: equal config hashes and canonical JSON, one store read by
both, equal gate verdicts. ``--profile`` on the CPU writes a
``torch.profiler`` Chrome trace. Every file is written under
``tmp_path``; no test reads or writes the default store.
"""
from __future__ import annotations

import glob
import json
import os
import re

import numpy as np
import pytest
import torch

from repro import results as jres
from repro_torch import results as res
from repro_torch.launch import bench_summary
from repro_torch.results import (BenchRun, ResultsStore, canonical_json,
                                 check_store, config_hash, fingerprint,
                                 fingerprint_key, higher, lower,
                                 make_record)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU_FP = {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
          "torch_version": "2.13.0"}
GPU_FP = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
          "device_count": 1, "torch_version": "2.13.0",
          "power_limit_w": 700.0}


def _rec(bench="kernel", config=None, metrics=None, fp=CPU_FP, **kw):
    return make_record(bench, config or {"mode": "sweep"},
                       metrics or {"best_gbps": higher(10.0)},
                       fp=fp, **kw)


def _seed_trajectory(store, values, metric="best_gbps", direction=higher,
                     cfg=None, fp=CPU_FP):
    for v in values:
        store.append(_rec(config=cfg or {"mode": "sweep"},
                          metrics={metric: direction(v)}, fp=fp))


@pytest.fixture(autouse=True)
def no_default_store(monkeypatch, tmp_path):
    """A run that forgets --store writes under tmp_path, never into the
    checkout."""
    monkeypatch.setenv("REPRO_TORCH_RESULTS_STORE",
                       str(tmp_path / "default_store"))


# ---------------------------------------------------------------------------
# config hash, canonical JSON (and the same bytes as the reference's)
# ---------------------------------------------------------------------------
def test_config_hash_stable_under_dict_key_order():
    a = {"steps": 20, "shapes": [[8, 4], [16, 8]], "dataset": "gowalla"}
    b = {"dataset": "gowalla", "shapes": [[8, 4], [16, 8]], "steps": 20}
    assert config_hash("kernel", a) == config_hash("kernel", b)
    a2 = {"cfg": {"x": 1, "y": 2}}
    b2 = {"cfg": {"y": 2, "x": 1}}
    assert config_hash("kernel", a2) == config_hash("kernel", b2)


def test_config_hash_sensitive_to_values_list_order_and_bench():
    base = {"shapes": [[8, 4], [16, 8]]}
    assert config_hash("kernel", base) \
        != config_hash("kernel", {"shapes": [[16, 8], [8, 4]]})
    assert config_hash("kernel", base) != config_hash("server", base)
    assert config_hash("kernel", base) \
        != config_hash("kernel", {"shapes": [[8, 4], [16, 8]], "x": 1})


def test_canonical_json_normalizes_tuples_numpy_and_torch():
    assert canonical_json({"a": (1, 2)}) == canonical_json({"a": [1, 2]})
    assert canonical_json({"a": np.int64(3)}) == canonical_json({"a": 3})
    assert canonical_json({"a": torch.tensor(3)}) == canonical_json({"a": 3})
    assert canonical_json({"a": torch.tensor(0.5)}) \
        == canonical_json({"a": 0.5})
    assert canonical_json({"t": torch.float32}) \
        == canonical_json({"t": "torch.float32"})
    with pytest.raises(TypeError):
        canonical_json({"a": object()})
    with pytest.raises(TypeError):
        canonical_json({"a": torch.zeros(2)})      # only 0-d tensors


CROSS_CONFIGS = [
    {"mode": "sweep", "sweep_shapes": [(256, 4096, 64, 1)], "repeats": 3},
    {"repeats": 3, "sweep_shapes": [(256, 4096, 64, 1)], "mode": "sweep"},
    {"n": np.int64(7), "x": np.float32(0.25), "flag": np.bool_(True),
     "nested": {"b": (1, 2), "a": [np.int32(3)]}},
    {"dataset": "amazonbook", "dim": 64, "batch": 2048, "steps": 32,
     "rounds": 5, "chunks": (1, 8, 32)},
    {"deadline_ms": None, "qps": 120.0, "buckets": (1, 8, 64)},
]


@pytest.mark.parametrize("config", CROSS_CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(CROSS_CONFIGS))])
@pytest.mark.parametrize("bench", ["kernel", "train_pipeline"])
def test_config_hash_and_canonical_json_equal_the_reference(bench, config):
    assert canonical_json(config) == jres.canonical_json(config)
    assert config_hash(bench, config) == jres.config_hash(bench, config)


# ---------------------------------------------------------------------------
# fingerprints: the port's keys never share a trajectory with another
# environment's
# ---------------------------------------------------------------------------
def test_fingerprint_on_the_cpu():
    fp = fingerprint("cpu")
    assert fp["platform"] == "cpu" and fp["device_count"] == 1
    assert fp["torch_version"] == torch.__version__
    assert "power_limit_w" not in fp and "jax_version" not in fp
    assert fingerprint_key(fp) == f"cpu:cpu:1:torch{torch.__version__}"


def test_fingerprint_keys_separate_cards_power_limits_and_packages():
    key = fingerprint_key(GPU_FP)
    assert key == "gpu:NVIDIA H100 80GB HBM3:1:torch2.13.0:700W"
    assert fingerprint_key(dict(GPU_FP, power_limit_w=350.0)) != key
    jax_tpu = {"platform": "tpu", "device_kind": "TPU v4",
               "device_count": 8, "jax_version": "0.4.37"}
    assert jres.fingerprint_key(jax_tpu) != key
    assert fingerprint_key({"imported": True}) == "imported"


def test_fingerprint_of_a_cuda_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        fingerprint("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BenchRun("kernel").parse([])        # --device defaults to cuda


def test_default_store_root_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_RESULTS_STORE")
    monkeypatch.setenv("REPRO_RESULTS_STORE", "/elsewhere")
    assert res.default_store_root() == "results_store_torch"
    monkeypatch.setenv("REPRO_TORCH_RESULTS_STORE", "/mine")
    assert res.default_store_root() == "/mine"
    assert res.default_store_root() != jres.default_store_root()


# ---------------------------------------------------------------------------
# store: append-only, fingerprint isolation, bless
# ---------------------------------------------------------------------------
def test_append_only_invariant(tmp_path):
    store = ResultsStore(str(tmp_path / "store"))
    store.append(_rec(metrics={"best_gbps": higher(10.0)}))
    shard = store.shard_path("kernel")
    before = open(shard, "rb").read()
    store.append(_rec(metrics={"best_gbps": higher(11.0)}))
    after = open(shard, "rb").read()
    assert after.startswith(before)
    assert len(store.records("kernel")) == 2


def test_corrupt_lines_surfaced_not_dropped(tmp_path):
    store = ResultsStore(str(tmp_path))
    store.append(_rec())
    with open(store.shard_path("kernel"), "a") as f:
        f.write("{not json\n")
    lines = store.lines("kernel")
    assert [ln.get("op") for ln in lines] == [None, "corrupt"]
    assert len(store.records("kernel")) == 1


def test_fingerprint_mismatch_isolates_trajectories(tmp_path):
    store = ResultsStore(str(tmp_path))
    cfg = {"mode": "sweep"}
    store.append(_rec(config=cfg, fp=CPU_FP,
                      metrics={"best_gbps": higher(10.0)}))
    store.append(_rec(config=cfg, fp=GPU_FP,
                      metrics={"best_gbps": higher(500.0)}))
    chash = config_hash("kernel", cfg)
    cpu_key, gpu_key = fingerprint_key(CPU_FP), fingerprint_key(GPU_FP)
    assert cpu_key != gpu_key
    assert [r["metrics"]["best_gbps"]["value"]
            for r in store.history("kernel", chash, cpu_key)] == [10.0]
    assert [r["metrics"]["best_gbps"]["value"]
            for r in store.history("kernel", chash, gpu_key)] == [500.0]
    warnings, notes = check_store(store)
    assert warnings == []
    assert len(notes) == 2 and all("first record" in n for n in notes)


def test_bless_restarts_trajectory(tmp_path):
    store = ResultsStore(str(tmp_path))
    cfg = {"mode": "sweep"}
    chash = config_hash("kernel", cfg)
    key = fingerprint_key(CPU_FP)
    store.append(_rec(config=cfg, metrics={"p50_ms": lower(1.0)}))
    store.bless("kernel", chash, reason="accepted slower path")
    store.append(_rec(config=cfg, metrics={"p50_ms": lower(5.0)}))
    hist = store.history("kernel", chash, key)
    assert [r["metrics"]["p50_ms"]["value"] for r in hist] == [5.0]
    warnings, _ = check_store(store)
    assert warnings == []


def test_imported_records_never_satisfy_cache(tmp_path):
    store = ResultsStore(str(tmp_path))
    rec = _rec(config={"mode": "sweep"},
               fp={"imported": True, "platform": "cpu"})
    assert rec["fingerprint_key"] == "imported"
    store.append(rec)
    assert not store.has("kernel", rec["config_hash"], "imported")


# ---------------------------------------------------------------------------
# gate: declared directions, thresholds, fallbacks
# ---------------------------------------------------------------------------
def test_gate_fires_on_25pct_regression_higher_is_better(tmp_path):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [10.0, 10.2, 9.9, 7.5])
    warnings, _ = check_store(store, threshold=0.20)
    assert len(warnings) == 1
    assert "best_gbps" in warnings[0]
    assert "higher-is-better" in warnings[0]


def test_gate_fires_on_25pct_regression_lower_is_better(tmp_path):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [8.0, 8.1, 7.9, 10.0], metric="p50_ms",
                     direction=lower)
    warnings, _ = check_store(store, threshold=0.20)
    assert len(warnings) == 1 and "p50_ms" in warnings[0]
    assert "lower-is-better" in warnings[0]


def test_gate_quiet_within_threshold(tmp_path):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [10.0, 10.2, 9.9, 9.0])
    warnings, _ = check_store(store, threshold=0.20)
    assert warnings == []


def test_gate_zero_baseline_rule(tmp_path):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [0, 0, 2], metric="state_allocations",
                     direction=lower)
    warnings, _ = check_store(store)
    assert len(warnings) == 1 and "rose from 0" in warnings[0]


def test_gate_uses_median_of_last_n(tmp_path):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [1.0, 1.0, 1.0, 10.0, 10.0, 7.0])
    warnings, _ = check_store(store, threshold=0.20, last_n=2)
    assert len(warnings) == 1 and "n=2" in warnings[0]
    warnings_all, _ = check_store(store, threshold=0.20, last_n=5)
    assert warnings_all == []


def test_gate_imported_fallback_is_advisory(tmp_path):
    store = ResultsStore(str(tmp_path))
    store.append(make_record(
        "kernel", {"imported_from": "BENCH_kernel.json"},
        {"best_fused_gbps": higher(10.0, direction_source="heuristic")},
        fp={"imported": True, "platform": "cpu"}))
    store.append(_rec(metrics={"best_fused_gbps": higher(6.0)}))
    warnings, notes = check_store(store, threshold=0.20)
    assert warnings == []
    assert any("no same-fingerprint history" in n for n in notes)
    assert any("imported legacy baseline" in n for n in notes)


def test_store_native_records_declare_directions():
    rec = _rec(metrics={"best_speedup_vs_seed": higher(3.0),
                        "sweep_ms": lower(22.0)})
    assert rec["metrics"]["best_speedup_vs_seed"]["higher_is_better"] is True
    assert rec["metrics"]["sweep_ms"]["higher_is_better"] is False
    with pytest.raises(ValueError):
        make_record("kernel", {}, {"raw": 3.0}, fp=CPU_FP)


# ---------------------------------------------------------------------------
# the two packages on one store
# ---------------------------------------------------------------------------
def _mixed_records(make, fp):
    return [make("kernel", {"mode": "sweep", "shapes": [(8, 4)]},
                 {"best_gbps": {"value": v, "higher_is_better": True},
                  "p50_ms": {"value": 2.0 + i, "higher_is_better": False}},
                 payload={"rows": [{"us": np.float64(v)}]}, fp=fp)
            for i, v in enumerate([10.0, 10.4, 9.7, 6.0])] + \
        [make("stream", {"n_users": 300}, {"state_allocations":
                                           {"value": n,
                                            "higher_is_better": False}},
              fp=fp) for n in (0, 0, 3)]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_store_lines_read_back_identically_in_both_packages(tmp_path,
                                                            writer):
    make, store_cls = ((make_record, ResultsStore) if writer == "port"
                       else (jres.make_record, jres.ResultsStore))
    written = store_cls(str(tmp_path))
    for r in _mixed_records(make, CPU_FP):
        written.append(r)
    written.bless("stream", config_hash("stream", {"n_users": 300}),
                  reason="x")
    port, ref = ResultsStore(str(tmp_path)), jres.ResultsStore(str(tmp_path))
    assert port.benches() == ref.benches() == ["kernel", "stream"]
    for bench in port.benches():
        assert port.lines(bench) == ref.lines(bench)
        assert port.records(bench) == ref.records(bench)
    chash = config_hash("kernel", {"mode": "sweep", "shapes": [(8, 4)]})
    key = port.records("kernel")[0]["fingerprint_key"]
    assert len(port.history("kernel", chash, key)) == 4
    assert port.history("kernel", chash, key) \
        == ref.history("kernel", chash, key)
    assert port.has("kernel", chash, key) and ref.has("kernel", chash, key)


@pytest.mark.parametrize("threshold,last_n", [(0.2, 5), (0.05, 2),
                                              (0.5, 3)])
def test_check_store_verdicts_equal_the_reference(tmp_path, threshold,
                                                  last_n):
    store = ResultsStore(str(tmp_path))
    for r in _mixed_records(make_record, CPU_FP) \
            + _mixed_records(make_record, GPU_FP):
        store.append(r)
    got = check_store(store, threshold=threshold, last_n=last_n)
    want = jres.check_store(jres.ResultsStore(str(tmp_path)),
                            threshold=threshold, last_n=last_n)
    assert got == want
    assert got[0], "the mixed records hold regressions to report"


# ---------------------------------------------------------------------------
# BenchRun: flags, emission, cache, profiler
# ---------------------------------------------------------------------------
def test_benchrun_emit_writes_store_and_mirror(tmp_path, capsys):
    out = tmp_path / "kernel.json"
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--json", "--store",
               str(tmp_path / "store"), "--out", str(out)])
    cfg = {"mode": "sweep"}
    run.emit(cfg, {"best_gbps": higher(10.0)}, payload={"bench": "kernel"})
    rec = ResultsStore(str(tmp_path / "store")).latest(
        "kernel", config_hash("kernel", cfg))
    assert rec is not None
    assert rec["metrics"]["best_gbps"] == {"value": 10.0,
                                           "higher_is_better": True}
    assert rec["fingerprint"] == fingerprint("cpu")
    assert json.loads(out.read_text()) == {"bench": "kernel"}
    printed = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(line) for line in printed] == [{"bench": "kernel"}]


def test_benchrun_cached_roundtrip_and_force(tmp_path, capsys):
    cfg = {"mode": "sweep"}
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--store", str(tmp_path)])
    assert run.cached(cfg) is None
    run.emit(cfg, {"best_gbps": higher(10.0)}, payload={"x": 1})
    hit = run.cached(cfg)
    assert hit is not None and hit["config_hash"] == config_hash(
        "kernel", cfg)
    assert run.cached({"mode": "other"}) is None
    replayed = BenchRun("kernel")
    replayed.parse(["--device", "cpu", "--store", str(tmp_path), "--json"])
    capsys.readouterr()
    replayed.replay(replayed.cached(cfg))
    out = capsys.readouterr()
    assert json.loads(out.out) == {"x": 1} and "cached" in out.err
    assert len(ResultsStore(str(tmp_path)).records("kernel")) == 1
    forced = BenchRun("kernel")
    forced.parse(["--device", "cpu", "--store", str(tmp_path), "--force"])
    assert forced.cached(cfg) is None


def test_benchrun_no_store(tmp_path):
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--no-store", "--store", str(tmp_path)])
    assert run.store is None
    run.emit({"m": 1}, {"g": higher(1.0)}, payload=None)
    assert not os.path.exists(str(tmp_path / "kernel.jsonl"))


def test_profile_flag_produces_nonempty_trace_dir(tmp_path):
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--profile", "--profile-dir",
               str(tmp_path / "prof"), "--store", str(tmp_path / "store")])
    with run.profile("smoke"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with run.profile("smoke"):
        torch.ones(8).sum()
    assert run.trace_dirs == [str(tmp_path / "prof" / "kernel" / "smoke"),
                              str(tmp_path / "prof" / "kernel" / "smoke-2")]
    for d in run.trace_dirs:
        files = [p for p in glob.glob(os.path.join(d, "**"), recursive=True)
                 if os.path.isfile(p)]
        assert files and all(os.path.getsize(p) > 0 for p in files)
        events = json.load(open(os.path.join(d, "trace.json")))
        assert any("aten::" in e.get("name", "")
                   for e in events["traceEvents"])
    assert run.device_events == [0, 0]          # no device on the CPU
    rec = run.emit({"mode": "sweep"}, {"g": higher(1.0)}, payload=None)
    assert rec["profile_trace_dirs"] == run.trace_dirs
    assert rec["profile_device_events"] == [0, 0]


def test_profile_off_is_noop(tmp_path):
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--store", str(tmp_path)])
    with run.profile("smoke"):
        pass
    assert run.trace_dirs == []


def test_trace_flag_exports_spans_onto_the_record(tmp_path):
    from repro_torch.obs import get_tracer, set_tracer
    from repro_torch.obs.trace import Tracer
    prev = get_tracer()
    set_tracer(Tracer(enabled=False))
    try:
        run = BenchRun("kernel")
        trace = tmp_path / "traces" / "kernel.jsonl"
        run.parse(["--device", "cpu", "--trace", "--trace-out", str(trace),
                   "--store", str(tmp_path / "store")])
        assert get_tracer().enabled
        assert not get_tracer().device_annotations     # no --profile
        with get_tracer().span("outer"):
            with get_tracer().span("inner"):
                pass
        rec = run.emit({"mode": "sweep"}, {"g": higher(1.0)}, payload=None)
    finally:
        set_tracer(prev)
    assert rec["obs"]["trace_file"] == str(trace)
    assert rec["obs"]["n_spans"] == 2
    assert set(rec["obs"]["span_rollup"]) == {"outer", "inner"}


# ---------------------------------------------------------------------------
# bench_summary on the store
# ---------------------------------------------------------------------------
def test_bench_summary_store_check_strict_exit(tmp_path, capsys):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [10.0, 10.1, 9.9, 6.0])
    assert bench_summary.main(["--check", "--store", str(tmp_path)]) == 0
    assert "WARNING" in capsys.readouterr().out
    assert bench_summary.main(["--check", "--store", str(tmp_path),
                               "--strict"]) == 1
    capsys.readouterr()
    chash = config_hash("kernel", {"mode": "sweep"})
    assert bench_summary.main(["--bless", f"kernel:{chash}", "--reason",
                               "ok", "--store", str(tmp_path)]) == 0
    assert bench_summary.main(["--check", "--store", str(tmp_path),
                               "--strict"]) == 0


def test_bench_summary_store_table(tmp_path, capsys):
    store = ResultsStore(str(tmp_path))
    _seed_trajectory(store, [10.0, 11.0])
    assert bench_summary.main(["--store", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "kernel[" in out and "n=2" in out and "best_gbps=11" in out
    assert bench_summary.main(["--store", str(tmp_path), "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["kernel"]) == 2


def test_bench_summary_check_prints_the_reference_gate(tmp_path, capsys):
    store = ResultsStore(str(tmp_path))
    for r in _mixed_records(make_record, CPU_FP):
        store.append(r)
    assert bench_summary.main(["--check", "--store", str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    warnings, notes = jres.check_store(jres.ResultsStore(str(tmp_path)))
    assert lines == [f"note: {n}" for n in notes] \
        + [f"WARNING: {w}" for w in warnings]


# ---------------------------------------------------------------------------
# architecture: the port's bench CLIs emit only through results
# ---------------------------------------------------------------------------
BENCH_CLIS = sorted(glob.glob(os.path.join(
    REPO, "src", "repro_torch", "launch", "*_bench.py"))) + [
    os.path.join(REPO, "src", "repro_torch", "launch", name)
    for name in ("cluster_scale.py", "roofline.py")]


def test_no_raw_json_dump_in_the_ports_bench_clis():
    """Every bench record of the port flows through repro_torch.results
    (BenchRun / dumps_record / write_record)."""
    assert len(BENCH_CLIS) == 7
    offenders = []
    for path in BENCH_CLIS:
        src = open(path).read()
        assert "BenchRun(" in src, f"{os.path.basename(path)} bypasses " \
                                   f"BenchRun"
        for i, line in enumerate(src.splitlines(), 1):
            if re.search(r"\bjson\.dumps?\s*\(", line):
                offenders.append(f"{os.path.basename(path)}:{i}: "
                                 f"{line.strip()}")
    assert offenders == [], (
        "raw json.dump(s) in the port's bench CLIs — emit through "
        "repro_torch.results instead:\n" + "\n".join(offenders))

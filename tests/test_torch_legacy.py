"""The legacy ``BENCH_*.json`` importer and the loose-file summary modes
(``results/legacy.py``, ``launch/migrate_store.py``,
``launch/bench_summary.py --dir/--against/--trace``) against the JAX
package's, and the guard that keeps imported records out of the card's
trajectories.

* ``migrate_store`` on the three committed ``BENCH_*.json`` files gives 3
  imported records (fingerprint key "imported", each file's own
  platform), and a second run imports nothing; their metrics equal the
  reference's ``legacy_metrics`` of the same files, as do the headlines
  and the direction heuristic.
* The guard: an imported record never joins a trajectory of the card,
  never satisfies the skip-if-measured cache, never turns into a
  ``--check`` warning or a ``--strict`` exit, however far it lies from the
  card's numbers; the gate's advisory notes name its platform.
  ``roofline --serving store`` skips it.
* ``bench_summary --dir`` prints the reference's legacy table, ``--check
  --against`` gives the reference's warnings, ``--trace`` renders the
  obs report before the table.
"""
import glob
import json
import os
import shutil

import pytest

from benchmarks import bench_summary as ref_summary
from repro.results import legacy as ref_legacy
from repro_torch.launch import bench_summary, migrate_store, obs_report
from repro_torch.launch import roofline
from repro_torch.results import (BenchRun, ResultsStore, check_store,
                                 config_hash, fingerprint_key, higher, lower,
                                 make_record)
from repro_torch.results import legacy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = sorted(glob.glob(os.path.join(REPO, "BENCH_*.json")))
GPU_FP = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
          "device_count": 1, "torch": "2.11.0", "cuda": "12.8",
          "power_limit_w": 700.0}


@pytest.fixture
def imported(tmp_path, capsys):
    store = str(tmp_path / "store")
    assert migrate_store.main(["--dir", REPO, "--store", store]) == 0
    first = capsys.readouterr().out
    return ResultsStore(store), first


def test_three_files_are_committed():
    assert [os.path.basename(f) for f in FILES] == [
        "BENCH_kernel.json", "BENCH_server.json", "BENCH_stream.json"]


def test_migrate_imports_three_records_once(imported, capsys):
    store, first = imported
    assert first.strip().splitlines()[-1].startswith("migration: 3 imported")
    recs = [r for b in store.benches() for r in store.records(b)]
    assert len(recs) == 3
    assert {r["fingerprint_key"] for r in recs} == {"imported"}
    lines = {b: store.lines(b) for b in store.benches()}
    assert migrate_store.main(["--dir", REPO, "--store", store.root]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1].startswith("migration: 3 skipped")
    assert {b: store.lines(b) for b in store.benches()} == lines
    for path in FILES:
        with open(path) as f:
            raw = json.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        rec = store.records(raw["bench"])[0]
        assert rec["fingerprint"]["platform"] == raw["platform"] == "cpu"
        assert rec["metrics"] == ref_legacy.legacy_metrics(name, raw)
        assert rec["payload"] == raw


def test_legacy_extraction_equals_the_reference():
    for path in FILES:
        with open(path) as f:
            raw = json.load(f)
        name = os.path.splitext(os.path.basename(path))[0]
        assert legacy.legacy_headline(name, raw) == \
            ref_legacy.legacy_headline(name, raw)
        assert legacy.legacy_metrics(name, raw) == \
            ref_legacy.legacy_metrics(name, raw)
    for metric in ("best p50_ms", "speedup_vs_seed", "records", "recall",
                   "compiles", "swap_pause_ms", "backend", "min_gap_s"):
        assert legacy.legacy_direction(metric) == \
            ref_legacy.legacy_direction(metric)


def _card_record(bench: str, config: dict, value: float, **metrics):
    return make_record(bench, config, {"best_fused_gbps": higher(value),
                                       **metrics}, payload={"bench": bench},
                       fp=GPU_FP)


def test_imported_records_stay_out_of_the_cards_trajectories(imported,
                                                             capsys):
    store, _ = imported
    cfg = {"mode": "sweep", "repeats": 100}
    # the card's first record, far below the imported CPU one's number
    store.append(_card_record("kernel", cfg, 1e-6,
                              lookup_errors=lower(50)))
    gpu_key = fingerprint_key(GPU_FP)
    chash = config_hash("kernel", cfg)
    assert [r["fingerprint_key"] for r in store.history(
        "kernel", chash, gpu_key)] == [gpu_key]
    imp = store.records("kernel")[0]
    assert not store.has("kernel", imp["config_hash"], "imported")
    warnings, notes = check_store(store, threshold=0.2)
    assert warnings == []
    assert any("imported legacy" in n and "platform cpu" in n for n in notes)
    assert any("[vs imported legacy baseline measured on platform cpu"
               in n for n in notes)
    assert bench_summary.main(["--store", store.root, "--check",
                               "--strict"]) == 0
    out = capsys.readouterr().out
    assert "WARNING" not in out and "platform cpu" in out
    # the table keeps the imported records to their own groups
    assert bench_summary.main(["--store", store.root]) == 0
    table = capsys.readouterr().out
    assert f"kernel[{chash[:8]}@{gpu_key}]  n=1" in table
    assert f"kernel[{imp['config_hash'][:8]}@imported]  n=1" in table
    # the skip-if-measured cache never answers with an imported record
    run = BenchRun("kernel")
    run.parse(["--device", "cpu", "--store", store.root])
    assert run.cached(imp["payload"]) is None


def test_roofline_serving_store_skips_imported_records(imported, capsys):
    store, _ = imported
    with pytest.raises(SystemExit, match="kernel_bench --json first"):
        roofline._load_serving_source("store", store)
    card = make_record("kernel", {"mode": "sweep"}, {},
                       payload={"bench": "kernel", "platform": "cuda",
                                "fused": []}, fp=GPU_FP)
    store.append(card)
    # an imported record newer than the card's is still skipped
    migrate_store.import_record(
        store, str(_renamed_kernel_file(store.root)))
    assert store.records("kernel")[-1]["fingerprint_key"] == "imported"
    payload, source = roofline._load_serving_source("store", store)
    assert payload["platform"] == "cuda"
    assert source["kernel_fingerprint_key"] == fingerprint_key(GPU_FP)


def _renamed_kernel_file(root: str) -> str:
    """The committed kernel file under another name: a new imported
    record of the same bench."""
    path = os.path.join(root, "BENCH_kernel_again.json")
    with open(FILES[0]) as f:
        raw = json.load(f)
    raw["bench"] = "kernel"
    raw["note"] = "again"
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def test_summary_dir_and_against_equal_the_reference(tmp_path, capsys):
    base, cur = tmp_path / "base", tmp_path / "cur"
    base.mkdir()
    cur.mkdir()
    for path in FILES:
        shutil.copy(path, base)
    with open(FILES[1]) as f:
        server = json.load(f)
    server["e2e_p99_ms"] *= 2             # a regression
    server["sustained_qps"] *= 0.5        # another
    for path in FILES:
        shutil.copy(path, cur)
    with open(cur / "BENCH_server.json", "w") as f:
        json.dump(server, f)
    (cur / "BENCH_broken.json").write_text("{not json")
    want = ref_summary.check(str(cur), str(base), threshold=0.2)
    assert bench_summary.check(str(cur), str(base), threshold=0.2) == want
    assert len(want) == 2
    assert bench_summary.main(["--dir", str(cur), "--check", "--against",
                               str(base), "--strict"]) == 1
    out = capsys.readouterr().out
    assert [ln[len("WARNING: "):] for ln in out.strip().splitlines()] == want
    for argv in (["--dir", str(cur)], ["--dir", str(cur), "--json"]):
        assert bench_summary.main(argv) == 0
        port = capsys.readouterr().out
        assert ref_summary.main(argv) == 0
        assert port == capsys.readouterr().out


def test_summary_trace_renders_the_obs_report(tmp_path, capsys):
    from repro_torch.obs import export_jsonl
    from repro_torch.obs.trace import Tracer

    tracer = Tracer(enabled=True)
    t = tracer.perf_t0 + 0.1
    req = tracer.record_span("request", t, t + 0.004, tenant="web")
    tracer.record_span("device", t + 0.001, t + 0.003, parent=req)
    path = str(tmp_path / "trace.jsonl")
    export_jsonl(tracer, path)
    store = str(tmp_path / "empty_store")
    assert bench_summary.main(["--trace", path, "--store", store]) == 1
    out = capsys.readouterr().out
    assert out.startswith(obs_report.report(path))
    assert "no records in results store" in out

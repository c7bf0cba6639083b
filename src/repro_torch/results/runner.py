"""BenchRun: the one entry-point API every bench of the port emits
through (port of ``repro.results.runner``).

A bench's ``main`` builds a :class:`BenchRun`, registers its own
arguments on ``run.parser``, and then:

    run = BenchRun("kernel", description=__doc__)
    run.add_argument("--full", action="store_true")
    args = run.parse(argv)              # resolves --device (cuda default)
    config = {"full": args.full, "shapes": SWEEP_SHAPES}
    hit = run.cached(config)
    if hit is not None:                 # skip-if-already-measured
        run.replay(hit)
        return 0
    with run.profile("sweep"):          # no-op unless --profile
        records = measure(..., device=run.device)
    run.emit(config,
             metrics={"best_gbps": higher(...), "p50_ms": lower(...)},
             payload=record)
    return 0

BenchRun owns the shared flags (the reference's ``--json --out --store
--no-store --force --profile --profile-dir --trace --trace-out
--trace-sample``, and ``--device``, default ``cuda``: without a CUDA
device :meth:`parse` raises unless the caller asks for ``cpu``) and the
three write paths:

  * the append to the content-keyed results store, by default
    ``$REPRO_TORCH_RESULTS_STORE`` or ``results_store_torch/`` (never the
    reference's committed ``results_store/``);
  * the ``--out`` mirror of the payload;
  * the ``--json`` stdout echo of the payload, as one line.

``--profile`` wraps any section passed through :meth:`profile` in a
``torch.profiler`` capture; on a CUDA run it always records the device
(``ProfilerActivity.CUDA``) and raises if the profiler cannot, or if
the capture holds no device event. Each capture is exported as a Chrome
trace, ``<profile-dir>/<bench>/<tag>[-n]/trace.json``; the directories
and their device-event counts are recorded on the emitted record.

``--trace`` turns on the port's global ``repro_torch.obs`` tracer for
the run (``--trace-sample`` sets the sampling rate; with ``--profile``
also the ``record_function`` bridge, so live spans appear as ranges in
the profile); :meth:`emit` then exports the spans to a JSONL file
(``--trace-out``, default ``traces/<bench>.jsonl``) and attaches its
path and per-span-name rollup to the record under ``extra["obs"]``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from .record import (config_hash, dumps_record, fingerprint,
                     fingerprint_key, make_record, write_record)
from .store import ResultsStore

__all__ = ["BenchRun", "default_store_root"]

_DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def default_store_root() -> str:
    """$REPRO_TORCH_RESULTS_STORE, else ./results_store_torch. The
    variable has its own name, so a shell that points the reference's
    benches at a store cannot mix H100 records into it."""
    return os.environ.get("REPRO_TORCH_RESULTS_STORE") \
        or "results_store_torch"


def _device_events(trace_path: str) -> int:
    """Device events (kernels, copies, sets) in an exported Chrome
    trace."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    return sum(1 for e in events if e.get("cat") in _DEVICE_EVENT_CATS)


class BenchRun:
    """Arg parsing + store write + ``--out`` mirror + profiler capture +
    incremental skip for one bench invocation."""

    def __init__(self, bench: str, description: str | None = None):
        self.bench = bench
        self.parser = argparse.ArgumentParser(
            description=description,
            formatter_class=argparse.RawDescriptionHelpFormatter)
        g = self.parser.add_argument_group("results store / output")
        g.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the kernels' plain "
                            "versions); without a CUDA device the run "
                            "raises unless cpu is asked for")
        g.add_argument("--json", action="store_true",
                       help="print the payload to stdout as one JSON line")
        g.add_argument("--out", default=None,
                       help="also mirror the payload to this path")
        g.add_argument("--store", default=None,
                       help="results-store directory (default: "
                            "$REPRO_TORCH_RESULTS_STORE or "
                            "./results_store_torch)")
        g.add_argument("--no-store", action="store_true",
                       help="do not touch the results store")
        g.add_argument("--force", action="store_true",
                       help="re-measure even when this exact config + "
                            "environment is already in the store")
        g.add_argument("--profile", action="store_true",
                       help="capture a torch.profiler trace around the "
                            "bench's hot sections")
        g.add_argument("--profile-dir", default="profiles",
                       help="root directory for --profile trace capture")
        g.add_argument("--trace", action="store_true",
                       help="enable repro_torch.obs span tracing for the "
                            "run and export a JSONL trace at emit time")
        g.add_argument("--trace-out", default=None,
                       help="trace export path (default: "
                            "traces/%s.jsonl)" % bench)
        g.add_argument("--trace-sample", type=float, default=1.0,
                       help="fraction of traces to keep under --trace "
                            "(head sampling; default 1.0)")
        self.args = None
        self.device = None
        self.trace_dirs = []
        self.device_events = []
        self._fp = None

    # -- argument plumbing ---------------------------------------------
    def add_argument(self, *a, **kw):
        return self.parser.add_argument(*a, **kw)

    def parse(self, argv=None) -> argparse.Namespace:
        from repro_torch.device import resolve_device
        self.args = self.parser.parse_args(argv)
        self.device = resolve_device(self.args.device)
        if self.args.trace:
            from repro_torch.obs import configure
            configure(enabled=True, sample_rate=self.args.trace_sample,
                      device_annotations=self.args.profile)
        return self.args

    def _require_args(self):
        if self.args is None:
            raise RuntimeError("BenchRun.parse() must run before "
                               "store/profile/emit are used")

    # -- store access ---------------------------------------------------
    @property
    def store(self):
        """ResultsStore for this run, or None under --no-store."""
        self._require_args()
        if self.args.no_store:
            return None
        return ResultsStore(self.args.store or default_store_root())

    def _fingerprint(self) -> dict:
        if self._fp is None:
            self._fp = fingerprint(self.device)
        return self._fp

    def cached(self, config: dict):
        """The stored record for this exact config + environment, or
        None when unmeasured (or under --force / --no-store)."""
        self._require_args()
        if self.args.force:
            return None
        store = self.store
        if store is None:
            return None
        chash = config_hash(self.bench, config)
        fkey = fingerprint_key(self._fingerprint())
        if not store.has(self.bench, chash, fkey):
            return None
        return store.latest(self.bench, chash, fkey)

    # -- profiler capture ----------------------------------------------
    def profile(self, tag: str = "trace"):
        """Context manager: a torch.profiler capture under --profile, a
        no-op otherwise. Each tag gets its own directory under
        <profile-dir>/<bench>/; repeated tags get -2, -3, ..."""
        self._require_args()
        if not self.args.profile:
            return contextlib.nullcontext()
        base = os.path.join(self.args.profile_dir, self.bench, tag)
        path, n = base, 1
        while path in self.trace_dirs or os.path.exists(path):
            n += 1
            path = f"{base}-{n}"
        return self._capture(path)

    @contextlib.contextmanager
    def _capture(self, path: str):
        from torch.profiler import (ProfilerActivity, profile,
                                    supported_activities)
        activities = [ProfilerActivity.CPU]
        cuda = self.device.type == "cuda"
        if cuda:
            if ProfilerActivity.CUDA not in supported_activities():
                raise RuntimeError(
                    "--profile on a CUDA run needs the profiler's CUDA "
                    "activity, which this torch build does not support")
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(path, exist_ok=True)
        self.trace_dirs.append(path)
        print(f"[{self.bench}] profiling -> {path}", file=sys.stderr,
              flush=True)
        with profile(activities=activities) as prof:
            yield prof
        trace = os.path.join(path, "trace.json")
        prof.export_chrome_trace(trace)
        n = _device_events(trace)
        self.device_events.append(n)
        if cuda and n == 0:
            raise RuntimeError(f"the profile of a CUDA run holds no device "
                               f"event ({trace})")

    # -- obs trace export -----------------------------------------------
    def _export_trace(self):
        """Under --trace: drain the global tracer to --trace-out and
        return the record annotation ({trace_file, n_spans,
        span_rollup}); None otherwise."""
        if not getattr(self.args, "trace", False):
            return None
        from repro_torch.obs import export_jsonl, get_tracer
        from repro_torch.obs.report import read_trace, rollup
        path = self.args.trace_out or os.path.join(
            "traces", f"{self.bench}.jsonl")
        n = export_jsonl(get_tracer(), path, drain=True)
        print(f"[{self.bench}] trace -> {path} ({n} spans)",
              file=sys.stderr, flush=True)
        return {"trace_file": path, "n_spans": n,
                "span_rollup": rollup(read_trace(path)["spans"])}

    # -- emission -------------------------------------------------------
    def _echo(self, payload) -> None:
        if self.args.json:
            print(dumps_record(payload, indent=None), flush=True)
        if self.args.out:
            write_record(self.args.out, payload)

    def emit(self, config: dict, metrics: dict, payload) -> dict:
        """Record a finished measurement: append to the store, mirror
        the payload to --out, echo it to stdout under --json. Returns
        the store record."""
        self._require_args()
        extra = {}
        if self.trace_dirs:
            extra["profile_trace_dirs"] = list(self.trace_dirs)
            extra["profile_device_events"] = list(self.device_events)
        obs_extra = self._export_trace()
        if obs_extra:
            extra["obs"] = obs_extra
        rec = make_record(self.bench, config, metrics, payload=payload,
                          fp=self._fingerprint(), extra=extra)
        store = self.store
        if store is not None:
            store.append(rec)
        self._echo(payload)
        return rec

    def replay(self, record: dict) -> dict:
        """Serve a cache hit: re-emit the stored payload through the same
        --json/--out paths a fresh measurement would use, and say so on
        stderr. Nothing is appended to the store."""
        self._require_args()
        payload = record.get("payload")
        print(f"[{self.bench}] cached: config {record['config_hash']} "
              f"already measured on this environment "
              f"({record.get('created_at', '?')}); use --force to "
              f"re-measure", file=sys.stderr, flush=True)
        if payload is not None:
            self._echo(payload)
        return record

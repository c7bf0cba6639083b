"""Record schema for the port's results store (port of
``repro.results.record``).

A record is one measurement of one benchmark configuration on one
machine. Three pieces of identity key it:

  * ``bench``        — the benchmark's registered kind ("kernel",
                       "server", "cluster_scale", ...);
  * ``config_hash``  — sha256 (truncated) of the canonical JSON of
                       {bench, config}, where ``config`` holds every
                       code-relevant knob the bench was invoked with.
                       Dict key order never changes the hash; list
                       order does. The same bench and config give the
                       same hash in both packages;
  * ``fingerprint``  — the environment the number was measured on:
                       platform ("gpu" or "cpu"), device kind and count,
                       torch and CUDA versions and, on the card, its
                       power limit. Records from different fingerprints
                       never share a trajectory: an H100 record never
                       shares one with a JAX/TPU record, and a 700 W card
                       never with a 350 W one.

Metrics are declared with an explicit direction at emission time via
:func:`higher` / :func:`lower`.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import platform as _platform
import subprocess

SCHEMA_VERSION = 1

__all__ = ["SCHEMA_VERSION", "canonical_json", "config_hash",
           "fingerprint", "fingerprint_key", "higher", "lower",
           "make_record", "dumps_record", "write_record"]


def _normalize(obj):
    """JSON-able copy with deterministic scalar types: tuples become
    lists, numpy scalars and 0-d torch tensors become python scalars, a
    ``torch.dtype`` its name, dict keys str. Raises TypeError for
    anything that cannot round-trip through JSON.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return obj
    if isinstance(obj, float):
        return obj
    if isinstance(obj, dict):
        return {str(k): _normalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if type(obj).__module__.startswith("torch"):
        import torch
        if isinstance(obj, torch.dtype):
            return str(obj)
        if isinstance(obj, torch.Tensor) and obj.dim() != 0:
            raise TypeError(f"a results record holds 0-d tensors only, got "
                            f"shape {tuple(obj.shape)}")
    # numpy scalars and 0-d tensors (anything exposing .item())
    item = getattr(obj, "item", None)
    if callable(item):
        return _normalize(item())
    raise TypeError(f"not JSON-able for a results record: {type(obj)!r}")


def canonical_json(obj) -> str:
    """Deterministic JSON: sorted keys, no whitespace, normalized
    scalar types — the byte string config hashes are computed over."""
    return json.dumps(_normalize(obj), sort_keys=True,
                      separators=(",", ":"))


def config_hash(bench: str, config: dict) -> str:
    """Content key of a benchmark configuration. Stable under dict key
    order; sensitive to every value (and to list order)."""
    text = canonical_json({"bench": bench, "config": config})
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def _power_limit_w(index: int) -> float:
    """The card's power limit in watts, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip()
    return float(out.splitlines()[0].rsplit(",", 1)[1].strip().split()[0])


def fingerprint(device="cuda") -> dict:
    """Environment fingerprint of this process on ``device``: platform
    ("gpu" or "cpu"), device kind and count, torch / CUDA / python
    versions, machine; on the card also ``power_limit_w`` (from
    ``nvidia-smi``; raises when it cannot be read). torch is imported
    lazily so store reads never pay for it."""
    import torch
    dev = torch.device(device)
    fp = {"platform": "gpu" if dev.type == "cuda" else "cpu"}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("fingerprint of a CUDA run without a CUDA "
                               "device")
        index = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        fp["device_kind"] = torch.cuda.get_device_name(index)
        fp["device_count"] = int(torch.cuda.device_count())
        try:
            fp["power_limit_w"] = _power_limit_w(index)
        except (OSError, subprocess.SubprocessError, ValueError,
                IndexError) as e:
            raise RuntimeError(f"cannot read the card's power limit from "
                               f"nvidia-smi: {e}") from e
    else:
        fp["device_kind"] = "cpu"
        fp["device_count"] = 1
    fp.update(torch_version=torch.__version__,
              cuda_version=torch.version.cuda,
              python_version=_platform.python_version(),
              machine=_platform.machine())
    return fp


def fingerprint_key(fp: dict) -> str:
    """The trajectory-isolation key,
    ``<platform>:<device_kind>:<count>:torch<ver>[:<power>W]`` (the
    power term on the card only). Imported legacy records
    (``fp["imported"]`` truthy) all collapse to the sentinel key
    "imported"."""
    if fp.get("imported"):
        return "imported"
    key = (f"{fp.get('platform', '?')}:{fp.get('device_kind', '?')}"
           f":{fp.get('device_count', '?')}"
           f":torch{fp.get('torch_version', '?')}")
    if fp.get("power_limit_w") is not None:
        key += f":{float(fp['power_limit_w']):g}W"
    return key


def higher(value, **extra) -> dict:
    """Declare a metric whose larger values are better (speedups,
    bandwidth, recall, QPS)."""
    return {"value": value, "higher_is_better": True, **extra}


def lower(value, **extra) -> dict:
    """Declare a metric whose smaller values are better (latencies,
    wall times, allocation/error counts, bytes)."""
    return {"value": value, "higher_is_better": False, **extra}


def make_record(bench: str, config: dict, metrics: dict,
                payload=None, fp: dict | None = None,
                extra: dict | None = None) -> dict:
    """Assemble one store record. ``metrics`` maps name -> the dict
    produced by :func:`higher` / :func:`lower`; every entry must carry
    an explicit ``higher_is_better``. ``fp`` defaults to the
    fingerprint of a CUDA run."""
    for name, m in metrics.items():
        if not isinstance(m, dict) or "higher_is_better" not in m \
                or "value" not in m:
            raise ValueError(
                f"metric {name!r} must declare its direction at emission "
                f"time — use results.higher(v) / lower(v), got {m!r}")
    fp = dict(fp) if fp is not None else fingerprint()
    rec = {
        "schema": SCHEMA_VERSION,
        "bench": bench,
        "config": _normalize(config),
        "config_hash": config_hash(bench, config),
        "fingerprint": fp,
        "fingerprint_key": fingerprint_key(fp),
        "created_at": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "metrics": {str(k): _normalize(v) for k, v in metrics.items()},
    }
    if payload is not None:
        rec["payload"] = _normalize(payload)
    if extra:
        rec.update(_normalize(extra))
    return rec


def dumps_record(obj, indent: int = 2) -> str:
    """The one sanctioned JSON serializer for bench records (the port's
    bench CLIs call no raw ``json.dump(s)``). Strictness lives in
    :func:`make_record`; here stray objects degrade to ``str`` so a
    diagnostic payload never kills a bench at write time."""
    return json.dumps(obj, indent=indent, default=str)


def write_record(path: str, obj) -> None:
    """Write a record (or any JSON-able object) to ``path`` (the
    ``--out`` mirror)."""
    with open(path, "w") as f:
        f.write(dumps_record(obj) + "\n")

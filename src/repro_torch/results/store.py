"""Append-only results store: sharded JSONL, one shard per bench kind
(a copy of ``repro.results.store``: a line written by either package's
store reads back identically in the other).

The runtime/store split follows orco: benchmarks (the runtime) only
ever *append* finished records through :class:`ResultsStore`; readers
(bench_summary, the CI gate, roofline) query trajectories out of the
same files. Nothing in this module rewrites a shard in place — history
is the product, so the only mutation is ``open(path, "a")``.

Shard layout::

    <root>/<bench>.jsonl      # one canonical-JSON object per line

Two line kinds live in a shard:

  * records — the dicts built by ``record.make_record``
    (no ``"op"`` key);
  * markers — control lines with an ``"op"`` key. The only marker today
    is ``{"op": "bless", "config_hash": ...}``: it declares every
    earlier record of that config-hash a non-baseline (an intentional
    regression was accepted), so the trajectory restarts after it.
"""
from __future__ import annotations

import datetime
import json
import os

from .record import canonical_json

__all__ = ["ResultsStore"]


class ResultsStore:
    """Append-only store rooted at a directory of per-bench JSONL
    shards. Safe to point at a non-existent directory — it is created
    on first append; reads of a missing store are just empty."""

    def __init__(self, root: str):
        self.root = str(root)

    # -- paths ----------------------------------------------------------
    def shard_path(self, bench: str) -> str:
        safe = "".join(c if (c.isalnum() or c in "-_") else "_"
                       for c in bench)
        return os.path.join(self.root, f"{safe}.jsonl")

    def benches(self) -> list:
        if not os.path.isdir(self.root):
            return []
        return sorted(os.path.splitext(f)[0] for f in os.listdir(self.root)
                      if f.endswith(".jsonl"))

    # -- writes (append is the only mutation) ---------------------------
    def append(self, record: dict) -> dict:
        """Append one record (or marker) to its bench shard. The line
        is canonical JSON, so shards diff cleanly under git."""
        bench = record.get("bench")
        if not bench:
            raise ValueError("record missing its 'bench' kind")
        os.makedirs(self.root, exist_ok=True)
        with open(self.shard_path(bench), "a") as f:
            f.write(canonical_json(record) + "\n")
        return record

    def bless(self, bench: str, config_hash: str, reason: str = "") -> dict:
        """Accept an intentional regression: every record of
        ``config_hash`` appended before this marker stops counting as
        baseline. The marker is itself an append — nothing is erased."""
        marker = {
            "op": "bless", "bench": bench, "config_hash": config_hash,
            "reason": reason,
            "created_at": datetime.datetime.now(
                datetime.timezone.utc).isoformat(timespec="seconds"),
        }
        return self.append(marker)

    # -- reads ----------------------------------------------------------
    def lines(self, bench: str) -> list:
        """Every line of a shard (records AND markers), in append
        order. Corrupt lines are surfaced as {"op": "corrupt", ...}
        rather than silently dropped."""
        path = self.shard_path(bench)
        if not os.path.exists(path):
            return []
        out = []
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError as e:
                    out.append({"op": "corrupt", "bench": bench,
                                "line": i + 1, "error": str(e)})
        return out

    def records(self, bench: str) -> list:
        """Measurement records of one bench, in append order."""
        return [ln for ln in self.lines(bench) if "op" not in ln]

    def all_records(self) -> dict:
        """{bench: [records]} across every shard."""
        return {b: self.records(b) for b in self.benches()}

    def history(self, bench: str, config_hash: str,
                fingerprint_key=None) -> list:
        """The live trajectory of one configuration: records matching
        ``config_hash`` (and ``fingerprint_key``, when given) in append
        order, truncated to those after the last ``bless`` marker for
        that config-hash."""
        out = []
        for ln in self.lines(bench):
            if ln.get("op") == "bless" \
                    and ln.get("config_hash") == config_hash:
                out = []
                continue
            if "op" in ln or ln.get("config_hash") != config_hash:
                continue
            if fingerprint_key is not None \
                    and ln.get("fingerprint_key") != fingerprint_key:
                continue
            out.append(ln)
        return out

    def latest(self, bench: str, config_hash: str,
               fingerprint_key=None):
        """Most recent live record of a configuration, or None."""
        hist = self.history(bench, config_hash, fingerprint_key)
        return hist[-1] if hist else None

    def has(self, bench: str, config_hash: str,
            fingerprint_key: str) -> bool:
        """True when a live measurement of this exact configuration on
        this exact environment already exists — the skip-if-measured
        predicate. Imported legacy records never count as measured."""
        if fingerprint_key == "imported":
            return False
        return self.latest(bench, config_hash, fingerprint_key) is not None

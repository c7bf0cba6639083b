"""TenantRegistry: many logical tenants, few device-resident sessions
(port of ``repro.frontdoor.tenants``).

An industrial deployment serves many logical surfaces (apps, markets,
A/B arms) from a small set of published artifact versions. Device memory
is the scarce resource, so sessions are pooled by ``content_id()``:
every tenant pinned to the same published artifact shares ONE
device-resident codebook session — attaching the hundredth tenant of a
popular version costs a dict entry, not a codebook upload.

Version changes go through ``swap(name, artifact)`` with three modes,
cheapest first:

  repointed  the target version is already resident (another tenant
             serves it) — the tenant just re-keys; zero device work.
  swapped    the tenant was the version's only user — the session hot
             swaps in place (``RecsysSession.swap``: copies into the
             session's device tensors, no allocation within its
             capacity rungs).
  attached   other tenants still pin the old version — it must keep
             serving, so the new version gets a fresh session (the one
             genuinely expensive mode: codebook upload + ladder warmup;
             counted so capacity planning sees it).

Sessions with no remaining tenants are evicted from the pool (their
device tensors become collectable). The registry itself is not locked —
the Frontdoor serializes all mutating calls under its dispatch lock,
which is also what gives swap its drain semantics.

The reference counts compiled XLA programs across the pool; the port
runs eagerly and counts ``state_allocations`` instead: the device
tensors the resident sessions allocated for their params and statics,
the quantity that must NOT grow under in-capacity traffic and swaps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.serve import BatchDispatcher, DEFAULT_BUCKETS, RecsysSession

__all__ = ["Tenant", "TenantRegistry"]


@dataclasses.dataclass
class Tenant:
    """One logical serving surface, pinned to an artifact version."""
    name: str
    artifact_id: str
    n_users: int                # current universe (load-gen convenience)
    swaps: int = 0


class _Entry:
    """One pooled device session + its bucket-ladder dispatcher."""

    def __init__(self, session, buckets):
        self.session = session
        self.dispatcher = BatchDispatcher(session, buckets=buckets)


class TenantRegistry:
    """Session pool keyed by artifact content_id, tenants on top.

    k/backend/scorer/buckets/capacity/device are the serving defaults
    every pooled session is built with (per-attach ``capacity``
    overrides); ``session_factory(artifact, capacity)`` can replace the
    RecsysSession constructor entirely (tests inject stub sessions
    through it).
    """

    def __init__(self, k: int = 20, capacity=None,
                 backend: Optional[str] = None,
                 scorer: Optional[str] = None,
                 buckets=DEFAULT_BUCKETS, session_factory=None,
                 device="cuda"):
        self.k = int(k)
        self.capacity = capacity
        self.backend = backend
        self.scorer = scorer
        self.buckets = tuple(buckets)
        self.device = device
        self._factory = session_factory or self._default_factory
        self._tenants: Dict[str, Tenant] = {}
        self._sessions: Dict[str, _Entry] = {}
        self.attaches = 0           # expensive session builds, ever

    def _default_factory(self, artifact, capacity):
        return RecsysSession.from_artifact(
            artifact, k=self.k, backend=self.backend,
            capacity=capacity if capacity is not None else self.capacity,
            scorer=self.scorer, device=self.device)

    # -- attach / lookup ----------------------------------------------------
    def attach(self, name: str, artifact, capacity=None,
               warmup: bool = True) -> Tenant:
        """Register a tenant serving ``artifact``; builds a session only
        if the version is not already resident. ``warmup`` runs every
        rung of the bucket ladder once on a fresh session (so the
        serving path never pays a first call under traffic)."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already attached "
                             f"(swap it instead)")
        aid = artifact.content_id()
        if aid not in self._sessions:
            self._sessions[aid] = _Entry(
                self._factory(artifact, capacity), self.buckets)
            self.attaches += 1
            if warmup:
                self._sessions[aid].dispatcher.warmup()
        tenant = Tenant(name=name, artifact_id=aid,
                        n_users=int(artifact.model["n_users"]))
        self._tenants[name] = tenant
        return tenant

    def attach_session(self, name: str, session, artifact_id: str,
                       n_users: int = 0) -> Tenant:
        """Escape hatch: register a pre-built session (stubs in tests,
        live-state sessions in benches) under an explicit version id."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already attached")
        if artifact_id not in self._sessions:
            self._sessions[artifact_id] = _Entry(session, self.buckets)
            self.attaches += 1
        tenant = Tenant(name=name, artifact_id=artifact_id,
                        n_users=int(n_users))
        self._tenants[name] = tenant
        return tenant

    def tenant(self, name: str) -> Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"unknown tenant {name!r}; attached: "
                           f"{sorted(self._tenants)}") from None

    def dispatcher(self, name: str) -> BatchDispatcher:
        return self._sessions[self.tenant(name).artifact_id].dispatcher

    def session(self, name: str):
        return self._sessions[self.tenant(name).artifact_id].session

    @property
    def tenants(self) -> tuple:
        return tuple(self._tenants)

    @property
    def n_sessions(self) -> int:
        return len(self._sessions)

    def sharers(self, artifact_id: str) -> tuple:
        return tuple(t.name for t in self._tenants.values()
                     if t.artifact_id == artifact_id)

    # -- version change -----------------------------------------------------
    def swap(self, name: str, artifact) -> dict:
        """Move one tenant to a new artifact version (see module doc for
        the three modes). Callers that need drain semantics must hold
        the dispatch lock around this call — the Frontdoor does."""
        tenant = self.tenant(name)
        old_id = tenant.artifact_id
        new_id = artifact.content_id()
        if new_id == old_id:
            return {"mode": "noop", "artifact_id": new_id}
        out = {"artifact_id": new_id}
        others = tuple(n for n in self.sharers(old_id) if n != name)
        if new_id in self._sessions:
            out["mode"] = "repointed"
        elif not others:
            entry = self._sessions.pop(old_id)
            out["session"] = entry.session.swap(artifact)
            self._sessions[new_id] = entry
            out["mode"] = "swapped"
        else:
            # the old version must keep serving its sharers: the new
            # version pays a full session build + ladder warmup
            self._sessions[new_id] = _Entry(
                self._factory(artifact, None), self.buckets)
            self._sessions[new_id].dispatcher.warmup()
            self.attaches += 1
            out["mode"] = "attached"
        tenant.artifact_id = new_id
        tenant.n_users = int(artifact.model["n_users"])
        tenant.swaps += 1
        # evict sessions no tenant references (device tensors collectable)
        live = {t.artifact_id for t in self._tenants.values()}
        for aid in [a for a in self._sessions if a not in live]:
            del self._sessions[aid]
        return out

    # -- telemetry ----------------------------------------------------------
    @property
    def state_allocations(self) -> int:
        """Device state tensors allocated by every resident session over
        its life — the quantity that must NOT grow under in-capacity
        traffic and swaps."""
        return sum(e.session.state_allocations
                   for e in self._sessions.values())

    def stats(self) -> dict:
        return {
            "tenants": {n: {"artifact_id": t.artifact_id,
                            "n_users": t.n_users, "swaps": t.swaps}
                        for n, t in sorted(self._tenants.items())},
            "sessions": len(self._sessions),
            "attaches": self.attaches,
            "state_allocations": self.state_allocations,
        }

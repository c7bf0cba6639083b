"""The port's serving front end (``repro_torch.frontdoor``) on the CPU.

The reference's frontdoor tests run again on the port's frontdoor, with
the port's own stub session (it returns CPU tensors, as a session does:
the port's ``BatchDispatcher`` copies outputs to the host): the chunk
plan, the dispatcher's identity property, tickets, the hot-user cache,
registry pooling and the four swap modes, coalescing and scatter under
many client threads, shed / block / deadline admission, input
validation, cache invalidation on swap, graceful stop, per-tenant
batches and open-loop accounting. Across the two packages:
``FrontdoorTelemetry.summary()`` has the reference's keys and
``record_batch`` the reference's pinned fill ratios; one request and one
swap leave spans with the reference's names and parentage; the load
generator draws the reference's arrivals and Zipf ids draw for draw; a
reference artifact and its delta-shipped v2, served by the reference's
``Frontdoor`` and the port's ``Frontdoor(device="cpu")`` with the same
synchronous requests and a swap halfway, give the same ids (near-tie
swaps within 1e-5 relative) and values to rtol 1e-5. A real port session
swapped under three client threads allocates no device state and every
response is wholly v1 or wholly v2. The CLIs run in subprocesses, and
the default-CUDA entry points raise without a GPU. The module runs with
one intra-op thread (``one_thread``).
"""
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import baco_build
from repro.data import planted_coclusters as jax_planted
from repro.frontdoor import Frontdoor as JaxFrontdoor
from repro.frontdoor import FrontdoorConfig as JaxFrontdoorConfig
from repro.frontdoor import loadgen as jax_loadgen
from repro.obs.trace import Tracer as JaxTracer
from repro.serve.telemetry import FrontdoorTelemetry as JaxTelemetry
from repro.training import TrainConfig as JaxTrainConfig
from repro.training import Trainer as JaxTrainer

from repro_torch.core import ClusterEngine
from repro_torch.data import planted_coclusters
from repro_torch.frontdoor import (DeadlineExceeded, Frontdoor,
                                   FrontdoorConfig, HotUserCache,
                                   RequestShed, TenantRegistry, Ticket,
                                   TrafficConfig, run_open_loop)
from repro_torch.frontdoor import loadgen
from repro_torch.obs.trace import Tracer
from repro_torch.serve import (BatchDispatcher, CompressedArtifact,
                               FrontdoorTelemetry, chunk_plan)
from repro_torch.training import TrainConfig, Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the frontdoor runs a batcher thread beside
    the caller's, and several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# stubs: the session protocol with identity-traceable outputs
# ---------------------------------------------------------------------------
class EchoSession:
    """values[i] = ids[i] + version * 1e6 — every output row names the
    input id that produced it AND the artifact version that served it,
    so scatter bugs and stale-version bugs are both detectable. Returns
    CPU tensors, as the port's sessions do."""

    def __init__(self, version: int = 0, delay_s: float = 0.0):
        self.version = version
        self.delay_s = delay_s
        self.calls = 0
        self.shapes = set()
        self.swap_epoch = 0
        self.artifact_id = f"echo-v{version}"
        self.state_allocations = 2

    def warmup(self, batch: int = 1):
        self.shapes.add(int(batch))

    def __call__(self, user_ids):
        ids = torch.as_tensor(np.asarray(user_ids, np.int64))
        self.calls += 1
        self.shapes.add(int(ids.shape[0]))
        if self.delay_s:
            time.sleep(self.delay_s)
        vals = ids.double() + self.version * 1e6
        items = torch.stack([ids, ids + 1], dim=1).int()
        return vals, items

    def swap(self, artifact):
        self.version = artifact.version
        self.swap_epoch += 1
        self.artifact_id = artifact.content_id()
        return {"ms": 0.0, "state_allocations": 0}

    def stats(self):
        return {"calls": self.calls}


class FakeArtifact:
    """content_id + model dict — all TenantRegistry needs."""

    def __init__(self, version: int, n_users: int = 1000):
        self.version = version
        self.model = {"n_users": n_users, "n_items": 500}

    def content_id(self):
        return f"fake-{self.version}"


def _registry(delay_s: float = 0.0, buckets=(1, 8, 64)):
    return TenantRegistry(
        buckets=buckets, device="cpu",
        session_factory=lambda art, cap: EchoSession(version=art.version,
                                                     delay_s=delay_s))


def _check_echo(ids, vals, items, version=0):
    ids = np.asarray(ids)
    assert vals.shape[0] == ids.size and items.shape[0] == ids.size
    np.testing.assert_array_equal(np.asarray(vals) - version * 1e6,
                                  ids.astype(np.float64))
    np.testing.assert_array_equal(np.asarray(items)[:, 0], ids)


def _frontdoor(delay_s=0.0, tracer=None, **kw):
    kw.setdefault("buckets", (1, 8, 64))
    fd = Frontdoor(FrontdoorConfig(device="cpu", **kw),
                   registry=_registry(delay_s=delay_s,
                                      buckets=kw["buckets"]),
                   tracer=tracer)
    fd.registry.attach("default", FakeArtifact(0))
    return fd


# ---------------------------------------------------------------------------
# chunk plan, dispatcher, tickets, cache
# ---------------------------------------------------------------------------
def test_chunk_plan_covers_and_buckets():
    rng = np.random.default_rng(0)
    buckets = (1, 8, 64)
    for _ in range(200):
        n = int(rng.integers(1, 300))
        plan = chunk_plan(n, buckets)
        assert sum(m for m, _ in plan) == n
        for m, b in plan:
            assert b in buckets and m <= b
            assert all(bb < m for bb in buckets if bb < b)
        assert all(m == buckets[-1] for m, _ in plan[:-1])
    with pytest.raises(ValueError, match="empty"):
        chunk_plan(0, (1, 8))


def test_dispatcher_identity_property():
    rng = np.random.default_rng(7)
    sess = EchoSession()
    disp = BatchDispatcher(sess, buckets=(1, 8, 64))
    for _ in range(100):
        n = int(rng.choice([1, 2, 7, 8, 9, 63, 64, 65, 130, 200]))
        ids = rng.integers(0, 10_000, n).astype(np.int32)
        vals, items = disp(ids)
        assert isinstance(vals, np.ndarray)
        _check_echo(ids, vals, items)
    assert sess.shapes <= set(disp.buckets), \
        "the ladder must bound the distinct shapes"
    assert disp.stats()["bucket_counts"][disp.buckets[-1]] > 0


def test_ticket_resolve_reject_timeout():
    t = Ticket()
    assert not t.done() and t.t_done is None
    with pytest.raises(TimeoutError):
        t.result(timeout=0.01)
    t.resolve(("v", "i"))
    assert t.done() and t.result() == ("v", "i")
    assert t.t_done is not None
    t2 = Ticket()
    t2.reject(RuntimeError("boom"))
    with pytest.raises(RuntimeError, match="boom"):
        t2.result()
    assert isinstance(t2.error(), RuntimeError) and t2.t_done >= t.t_done


def test_cache_all_or_nothing_and_lru():
    c = HotUserCache(max_entries=4)
    ids = np.arange(3, dtype=np.int32)
    vals = np.arange(3, dtype=np.float64)
    items = np.stack([ids, ids], axis=1)
    c.put("a", ids, vals, items)
    hit = c.get("a", np.asarray([2, 0], np.int32))
    assert hit is not None
    np.testing.assert_array_equal(hit[0], [2.0, 0.0])
    assert c.get("a", np.asarray([0, 99], np.int32)) is None
    assert c.get("b", np.asarray([0], np.int32)) is None
    c.put("a", np.asarray([10, 11], np.int32), vals[:2], items[:2])
    assert len(c) == 4
    assert c.get("a", np.asarray([1], np.int32)) is None   # evicted
    assert c.get("a", np.asarray([0], np.int32)) is not None
    c.put("b", ids[:1], vals[:1], items[:1])
    assert c.invalidate("a") == 3
    assert c.get("b", ids[:1]) is not None
    with pytest.raises(ValueError):
        HotUserCache(0)


# ---------------------------------------------------------------------------
# TenantRegistry: pooling + the swap modes
# ---------------------------------------------------------------------------
def test_registry_pools_sessions_by_content_id():
    reg = _registry()
    a1 = FakeArtifact(1)
    reg.attach("web", a1)
    reg.attach("mobile", a1)
    assert reg.n_sessions == 1 and reg.attaches == 1
    assert reg.session("web") is reg.session("mobile")
    assert sorted(reg.sharers("fake-1")) == ["mobile", "web"]
    assert reg.state_allocations == 2
    assert reg.stats()["state_allocations"] == 2
    assert "compiles" not in reg.stats()
    with pytest.raises(ValueError, match="already attached"):
        reg.attach("web", a1)
    with pytest.raises(KeyError, match="unknown tenant"):
        reg.tenant("nope")


def test_registry_swap_modes():
    reg = _registry()
    a1, a2 = FakeArtifact(1), FakeArtifact(2)
    reg.attach("web", a1)
    reg.attach("mobile", a1)
    assert reg.swap("web", a1)["mode"] == "noop"
    out = reg.swap("web", a2)
    assert out["mode"] == "attached"
    assert reg.n_sessions == 2 and reg.state_allocations == 4
    assert reg.session("web") is not reg.session("mobile")
    out = reg.swap("mobile", a2)
    assert out["mode"] == "repointed"
    assert reg.n_sessions == 1 and reg.state_allocations == 2
    assert reg.session("web") is reg.session("mobile")
    reg2 = _registry()
    reg2.attach("solo", a1)
    sess = reg2.session("solo")
    out = reg2.swap("solo", a2)
    assert out["mode"] == "swapped"
    assert reg2.session("solo") is sess
    assert sess.version == 2 and sess.swap_epoch == 1
    assert reg2.tenant("solo").swaps == 1


# ---------------------------------------------------------------------------
# Frontdoor: coalescing, identity under concurrency, policies, deadlines
# ---------------------------------------------------------------------------
def test_frontdoor_coalesces_and_scatters_correctly():
    """Many client threads (more than cores), a short switch interval,
    mixed sizes: every response maps back to exactly its request's ids
    through the shared-batch scatter."""
    fd = _frontdoor(flush_ms=5.0)
    results = {}
    rng = np.random.default_rng(3)
    requests = [(i, rng.integers(0, 5000, int(rng.choice([1, 2, 4, 8])))
                 .astype(np.int32)) for i in range(60)]

    def client(i, ids):
        results[i] = fd(ids, timeout=30)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with fd:
            threads = [threading.Thread(target=client, args=r)
                       for r in requests]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    st = fd.stats()
    for i, ids in requests:
        _check_echo(ids, *results[i])
    assert st["responses"] == len(requests)
    assert st["batches"] < len(requests), \
        "concurrent submits must coalesce into shared batches"
    assert st["coalesced"] > 0
    assert 0 < st["batch_fill_mean"] <= 1.0


@pytest.mark.parametrize("policy", ["shed", "block"])
def test_frontdoor_admission_policies(policy):
    """shed: a 2-deep queue against a 50 ms session refuses requests and
    counts them; block: a 1-deep queue makes submit wait and serves
    everything in order."""
    if policy == "shed":
        fd = _frontdoor(delay_s=0.05, queue_size=2, policy="shed",
                        flush_ms=0.5)
        shed, tickets = 0, []
        with fd:
            for i in range(30):
                try:
                    tickets.append(fd.submit(np.asarray([i], np.int32)))
                except RequestShed:
                    shed += 1
            for t in tickets:
                t.result(timeout=30)
        assert shed > 0
        assert fd.stats()["shed"] == shed
        assert fd.stats()["responses"] == len(tickets)
    else:
        fd = _frontdoor(delay_s=0.01, queue_size=1, policy="block",
                        flush_ms=0.5)
        with fd:
            tickets = [fd.submit(np.asarray([i], np.int32))
                       for i in range(10)]
            for i, t in enumerate(tickets):
                vals, _ = t.result(timeout=30)
                assert vals[0] == float(i)
        assert fd.stats()["shed"] == 0
        assert fd.stats()["responses"] == 10


def test_shed_counts_pinned_under_deterministic_overflow(monkeypatch):
    fd = Frontdoor(FrontdoorConfig(queue_size=4, policy="shed",
                                   buckets=(1, 8, 64), device="cpu"),
                   registry=_registry())
    fd.attach("web", FakeArtifact(0))
    monkeypatch.setattr(type(fd), "running", property(lambda self: True))
    for i in range(4):
        fd.submit([i], tenant="web")
    for i in range(3):
        with pytest.raises(RequestShed):
            fd.submit([i], tenant="web")
    s = fd.telemetry.summary()
    assert (s["requests"], s["shed"], s["responses"]) == (7, 3, 0)
    assert fd.queue_depth() == 4


def test_frontdoor_deadline_rejects_expired_unscored():
    fd = _frontdoor(delay_s=0.08, flush_ms=0.5)
    with fd:
        first = fd.submit(np.asarray([1], np.int32))
        time.sleep(0.01)
        doomed = fd.submit(np.asarray([2], np.int32), deadline_ms=10)
        first.result(timeout=30)
        with pytest.raises(DeadlineExceeded):
            doomed.result(timeout=30)
    st = fd.stats()
    assert st["timeouts"] == 1 and st["responses"] == 1
    assert fd.registry.session("default").calls == 1   # doomed: unscored


def test_frontdoor_validates_inputs():
    fd = _frontdoor()
    with pytest.raises(RuntimeError, match="not accepting"):
        fd.submit(np.asarray([1], np.int32))
    with fd:
        with pytest.raises(ValueError, match="empty"):
            fd.submit(np.asarray([], np.int32))
        with pytest.raises(KeyError, match="unknown tenant"):
            fd.submit(np.asarray([1], np.int32), tenant="nope")
    with pytest.raises(ValueError, match="unknown admission policy"):
        FrontdoorConfig(policy="drop", device="cpu")


def test_frontdoor_cache_hits_and_swap_invalidation():
    fd = _frontdoor(cache_entries=64, flush_ms=0.5)
    ids = np.asarray([7, 9], np.int32)
    with fd:
        _check_echo(ids, *fd(ids))
        _check_echo(ids, *fd(ids), version=0)      # from the cache
        st = fd.stats()
        assert st["cache_hits"] == 1 and st["cache_entries"] == 2
        out = fd.swap("default", FakeArtifact(4))
        assert out["mode"] == "swapped"
        assert out["cache_invalidated"] == 2
        _check_echo(ids, *fd(ids), version=4)      # a real dispatch
    assert fd.stats()["swaps"] == 1
    assert fd.stats()["swap_pause_p99_ms"] >= 0.0
    assert fd.stats()["registry"]["state_allocations"] == 2


def test_frontdoor_graceful_stop_serves_admitted():
    fd = _frontdoor(delay_s=0.005, flush_ms=50.0)
    with fd:
        tickets = [fd.submit(np.asarray([i], np.int32)) for i in range(5)]
    for t in tickets:
        assert t.result(timeout=30) is not None
    assert fd.stats()["responses"] == 5


def test_frontdoor_multi_tenant_batches_are_per_tenant():
    fd = _frontdoor(flush_ms=2.0)
    fd.registry.attach("other", FakeArtifact(5))
    with fd:
        a = fd.submit(np.asarray([1, 2], np.int32), tenant="default")
        b = fd.submit(np.asarray([3], np.int32), tenant="other")
        _check_echo([1, 2], *a.result(timeout=30), version=0)
        _check_echo([3], *b.result(timeout=30), version=5)
    assert fd.registry.n_sessions == 2


def test_run_open_loop_accounts_every_arrival():
    fd = _frontdoor(flush_ms=1.0)
    fired, log = [], []
    with fd:
        report = run_open_loop(
            fd, TrafficConfig(qps=300, duration_s=0.5, seed=1),
            actions=[(0.25, lambda: fired.append(len(log)) or "acted")],
            log=log)
    assert report["offered"] == report["submitted"] == len(log)
    assert report["responses"] == report["submitted"]
    assert report["shed"] == report["timeouts"] == report["failed"] == 0
    assert report["sustained_qps"] > 0
    assert report["action_results"] == ["acted"]
    assert 0 < fired[0] < len(log)
    for tenant, ids, ticket in log:
        assert tenant == "default"
        _check_echo(ids, *ticket.result(timeout=1))


# ---------------------------------------------------------------------------
# across the packages: telemetry, spans, load generator
# ---------------------------------------------------------------------------
def test_frontdoor_telemetry_matches_reference():
    port, ref = FrontdoorTelemetry(), JaxTelemetry()
    assert list(port.summary()) == list(ref.summary())
    for tel in (port, ref):
        tel.record_batch(2, 7, 8, [8])
        tel.bump("shed", 2)
        tel.e2e.record(1.5)
        tel.queue_delay.record(0.25)
    s, want = port.summary(), ref.summary()
    assert list(s) == list(want)
    for k, v in want.items():               # NaN: no swap recorded yet
        assert s[k] == v or (v != v and s[k] != s[k]), k
    assert s["batches"] == 1 and s["coalesced"] == 2
    assert s["batch_fill_mean"] == 0.875 and s["bucket_counts"] == {8: 1}
    port.record_batch(1, 3, 8, [8])
    s = port.summary()
    assert s["coalesced"] == 2
    assert s["batch_fill_mean"] == round((0.875 + 0.375) / 2, 4)
    port.record_batch(3, 65, 72, [64, 8])
    assert port.summary()["bucket_counts"] == {8: 3, 64: 1}


def _span_tree(tracer):
    spans = tracer.spans()
    by_id = {s.span_id: s.name for s in spans}
    return sorted((s.name, by_id.get(s.parent_id)) for s in spans)


def test_request_and_swap_spans_match_reference():
    from tests.test_frontdoor import FakeArtifact as JaxFake
    from tests.test_frontdoor import _registry as jax_registry
    trees = []
    for make in ("port", "reference"):
        if make == "port":
            tr = Tracer(enabled=True)
            fd = _frontdoor(tracer=tr, flush_ms=1.0)
            new = FakeArtifact(1)
        else:
            tr = JaxTracer(enabled=True, device_annotations=False)
            fd = JaxFrontdoor(JaxFrontdoorConfig(flush_ms=1.0,
                                                 buckets=(1, 8, 64)),
                              registry=jax_registry(), tracer=tr)
            fd.registry.attach("default", JaxFake(0))
            new = JaxFake(1)
        with fd:
            fd(np.asarray([3, 4], np.int32))
            fd.swap("default", new)
        trees.append(_span_tree(tr))
    assert trees[0] == trees[1]
    assert trees[0] == sorted([
        ("request", None), ("admit", "request"), ("queue", "request"),
        ("batch", "request"), ("dispatch", "batch"), ("device", "dispatch"),
        ("respond", "request"), ("frontdoor_swap", None),
        ("drain", "frontdoor_swap"), ("registry_swap", "frontdoor_swap")])


def test_port_tracer_record_span_and_clear():
    tr = Tracer(enabled=False)
    assert not tr.record_span("x", 0.0, 1.0)
    tr = Tracer(enabled=True)
    root = tr.trace("request")
    done = {}

    def other_thread():
        done["sp"] = tr.record_span("device", 1.0, 2.0, parent=root, n=3)

    t = threading.Thread(target=other_thread)
    t.start()
    t.join(timeout=10)
    root.end()
    sp = done["sp"]
    assert (sp.t_start, sp.t_end, sp.parent_id) == (1.0, 2.0, root.span_id)
    assert sp.attrs == {"n": 3} and sp.trace_id == root.trace_id
    assert len(tr.spans()) == 2
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_load_generator_draws_match_reference(seed):
    for burst in (1.0, 2.0, 3.0):
        cfgs = [mod.TrafficConfig(qps=150.0, duration_s=2.0,
                                  burst_factor=burst, seed=seed)
                for mod in (loadgen, jax_loadgen)]
        rngs = [np.random.default_rng(seed) for _ in range(2)]
        got = [mod.arrival_times(c, r)
               for mod, c, r in zip((loadgen, jax_loadgen), cfgs, rngs)]
        np.testing.assert_array_equal(got[0], got[1])
        for n_users in (1, 100, 52_643):
            for n, a in ((1, 1.1), (8, 1.1), (64, 1.5), (5, 2.0)):
                ids = [mod.zipf_ids(r, n, n_users, a)
                       for mod, r in zip((loadgen, jax_loadgen), rngs)]
                assert ids[0].dtype == np.int32
                np.testing.assert_array_equal(ids[0], ids[1])
        assert rngs[0].random() == rngs[1].random()   # in step after


# ---------------------------------------------------------------------------
# real sessions
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reference_versions(tmp_path_factory):
    """A reference artifact trained as in ``tests/test_frontdoor.py``
    (planted co-clusters, d 8) and its delta-shipped v2, each saved by
    the reference and loaded by the port."""
    graph, _, _ = jax_planted(n_users=150, n_items=110, k_true=6,
                              avg_deg=8, seed=0)
    sketch = baco_build(graph, d=8, ratio=0.3)
    tr = JaxTrainer(graph, sketch,
                    JaxTrainConfig(dim=8, steps=5, batch_size=64, lr=1e-2))
    tr.run(log_every=0)
    base = tr.export()
    tr.run(steps=tr.step + 3, log_every=0)
    v2 = base.apply_delta(tr.export().delta(base))
    assert v2.content_id() != base.content_id()
    out = tmp_path_factory.mktemp("ref_versions")
    port = [CompressedArtifact.load(a.save(str(out / name)))
            for name, a in (("base", base), ("v2", v2))]
    assert [a.content_id() for a in port] == [base.content_id(),
                                              v2.content_id()]
    return (base, v2), tuple(port)


@pytest.mark.parametrize("scorer", ["dense", "fused"])
def test_port_frontdoor_serves_the_reference_answers(reference_versions,
                                                     scorer):
    """The same synchronous requests (repeats included, so the cache
    answers some) with ``web`` swapped halfway, through both packages'
    frontdoors: the same ids up to near-ties, values to rtol 1e-5."""
    (jbase, jv2), (base, v2) = reference_versions
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, 150, int(rng.choice([1, 3, 8, 11])))
            .astype(np.int32) for _ in range(10)]
    reqs += reqs[:3]
    answers = []
    for fd, (a1, a2) in (
            (JaxFrontdoor(JaxFrontdoorConfig(k=5, buckets=(1, 8),
                                             cache_entries=64,
                                             scorer=scorer)), (jbase, jv2)),
            (Frontdoor(FrontdoorConfig(k=5, buckets=(1, 8),
                                       cache_entries=64, scorer=scorer,
                                       device="cpu")), (base, v2))):
        fd.attach("web", a1, capacity="auto")
        out = []
        with fd:
            for i, ids in enumerate(reqs):
                if i == 6:
                    assert fd.swap("web", a2)["mode"] == "swapped"
                out.append(fd(ids, tenant="web"))
            out += [fd(ids, tenant="web") for ids in reqs[:6]]
        assert fd.stats()["cache_hits"] > 0
        answers.append(out)
    n_ids = n_diff = 0
    for (wv, wi), (gv, gi) in zip(*answers):
        np.testing.assert_allclose(gv, np.asarray(wv), rtol=1e-5,
                                   atol=1e-7)
        diff = gi != np.asarray(wi)
        np.testing.assert_allclose(gv[diff], np.asarray(wv)[diff],
                                   rtol=1e-5)
        n_ids += diff.size
        n_diff += int(diff.sum())
    assert n_diff <= 0.02 * n_ids


@pytest.fixture(scope="module")
def port_versions():
    g, _, _ = planted_coclusters(150, 110, 6, 8, seed=0)
    sk = ClusterEngine(device="cpu").build(g, d=8, ratio=0.3)
    tr = Trainer(g, sk, TrainConfig(dim=8, steps=5, batch_size=64,
                                    lr=1e-2), device="cpu")
    tr.run(log_every=0)
    base = tr.export()
    cid = base.content_id()
    tr.run(steps=tr.step + 3, log_every=0)
    v2 = base.apply_delta(tr.export().delta(base))
    assert base.content_id() == cid, "the export must not alias the " \
        "trainer's tensors"
    assert v2.content_id() != cid
    return base, v2


def test_real_session_swap_under_three_clients(port_versions):
    base, v2 = port_versions
    fd = Frontdoor(FrontdoorConfig(k=5, buckets=(1, 8), cache_entries=0,
                                   device="cpu"))
    fd.attach("web", base, capacity="auto")
    warm = fd.state_allocations
    assert warm > 0
    sess = fd.registry.session("web")
    ptrs = {k: v.data_ptr() for k, v in {**sess.params,
                                         **sess.statics}.items()}
    got, errors = [], []

    def client(cid):
        rng = np.random.default_rng(cid)
        try:
            for _ in range(8):
                ids = rng.integers(0, 150, int(rng.choice([1, 3, 8])))
                vals, items = fd(ids.astype(np.int32), tenant="web")
                got.append((ids, vals, items))
        except Exception as e:                  # surface across threads
            errors.append(e)

    with fd:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        swap = fd.swap("web", v2)
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    assert not errors, errors[0]
    assert swap["mode"] == "swapped"
    assert swap["session"]["state_allocations"] == 0
    assert fd.registry.session("web") is sess
    assert sess.artifact_id == v2.content_id()
    assert fd.state_allocations == warm
    assert ptrs == {k: v.data_ptr() for k, v in {**sess.params,
                                                 **sess.statics}.items()}
    assert fd.stats()["responses"] == 3 * 8 == len(got)
    direct = [BatchDispatcher(a.session(k=5, device="cpu"), (1, 8))
              for a in (base, v2)]
    seen = set()
    for ids, vals, items in got:
        match = [v for v, d in enumerate(direct)
                 if all(np.array_equal(x, y)
                        for x, y in zip(d(ids), (vals, items)))]
        assert match, "a response is neither wholly v1 nor wholly v2"
        seen.update(match)
    assert 1 in seen


# ---------------------------------------------------------------------------
# CLIs and device defaults
# ---------------------------------------------------------------------------
def _run(module, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu",
         "--dataset", "synth_xs", "--dim", "8", "--qps", "40",
         "--duration", "0.5", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_frontdoor_cli_on_the_cpu():
    out = _run("repro_torch.launch.frontdoor", "--steps", "10",
               "--swap-mid-load", "--swap-extra-steps", "3")
    assert "mode=swapped" in out
    assert "state allocations under load: 0" in out


def test_load_bench_cli_json_on_the_cpu(tmp_path):
    out = _run("repro_torch.launch.load_bench", "--steps", "10",
               "--extra-steps", "3", "--json", "--store",
               str(tmp_path / "store"))
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["platform"] == "cpu" and rec["tenants"] == 3
    assert rec["sessions"] == 2 and rec["swap_mode"] == "swapped"
    assert rec["state_allocations_under_load"] == 0
    assert rec["allocator_segments_under_load"] is None
    assert rec["failed"] == 0
    assert (rec["responses"] + rec["shed"] + rec["timeouts"]
            + rec["failed"]) == rec["offered"]
    for key in ("sustained_qps", "e2e_p50_ms", "e2e_p99_ms",
                "queue_delay_p50_ms", "queue_delay_p99_ms",
                "batch_fill_mean", "bucket_counts", "cache_hits",
                "swap_pause_ms", "swap_drain_ms", "state_allocations_warm"):
        assert key in rec


def test_frontdoor_entry_points_default_to_cuda(monkeypatch, port_versions):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.launch import frontdoor as fd_cli
    from repro_torch.launch import load_bench
    base, _ = port_versions
    calls = [
        lambda: Frontdoor(),
        lambda: Frontdoor(FrontdoorConfig(queue_size=4)),
        lambda: TenantRegistry().attach("web", base),
        lambda: fd_cli.main(["--dataset", "synth_xs", "--steps", "1"]),
        lambda: load_bench.main(["--dataset", "synth_xs", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()

"""Streaming bench of the port: online co-clustering and hot-swap
serving (``python -m repro_torch.launch.stream_bench``; a port of
``benchmarks/stream_bench.py``, bench ``stream``).

Replays a drifting planted-co-cluster interaction stream
(``repro_torch.data.drifting_coclusters``) through the
``repro_torch.stream`` stack and records:

  * cold-assign latency per event batch (one LP half-step over the new
    nodes' incident edges), the first call apart from the warm p50;
  * total stream maintenance time (refresh solves + fine-tunes + cold
    assigns) against ONE full re-solve from scratch (BACO + full
    retrain) over the final graph;
  * hot-swap p50/p99, and the device state the swaps allocated
    (``swap_state_allocations``, which the capacity ladder keeps at 0;
    the reference counts XLA compiles there);
  * Recall@20 on held-out stream edges for the FROZEN warm artifact (new
    users fall back to codebook row 0, new items are unknown), the
    STREAMED artifact and a FULL re-solve, and the share of the
    frozen -> full recall gap the stream recovers.

The session scores with the fused top-k kernel (the reference serves
its default dense scorer; on the H100 the dense scorer spends most of a
request sorting every item). Host clock around work that ends in a
device synchronize.

    python -m repro_torch.launch.stream_bench --n-users 52643 --n-items 91599 --k-true 300 --dim 64
    python -m repro_torch.launch.stream_bench --device cpu --n-users 300 --n-items 240 --k-true 6 --no-store
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.obs import clock
from repro_torch.results import BenchRun, higher, lower

SCORER = "fused"


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _split_steps(steps, holdout: float, seed: int):
    """Per-step 90/10 split: train events replayed, test events held
    out (keyed off SeedSequence like the generator itself)."""
    from repro_torch.data import StreamStep
    rng = np.random.default_rng(np.random.SeedSequence([seed, 10_000]))
    train_steps, test_u, test_v = [], [], []
    for s in steps:
        mask = rng.random(s.edge_u.size) < holdout
        train_steps.append(StreamStep(s.n_new_users, s.n_new_items,
                                      s.edge_u[~mask], s.edge_v[~mask]))
        test_u.append(s.edge_u[mask])
        test_v.append(s.edge_v[mask])
    return train_steps, np.concatenate(test_u), np.concatenate(test_v)


def _drop_seen(test_u, test_v, graph):
    """Drop held-out pairs that also occur in the train graph (dup
    interactions across steps), so eval never masks a test item."""
    keys = test_u.astype(np.int64) * graph.n_items + test_v
    gkeys = graph.edge_u.astype(np.int64) * graph.n_items + graph.edge_v
    pos = np.searchsorted(gkeys, keys)
    pos = np.minimum(pos, max(gkeys.size - 1, 0))
    seen = (gkeys.size > 0) & (gkeys[pos] == keys)
    return test_u[~seen], test_v[~seen]


@torch.no_grad()
def artifact_recall(artifact, test_edges, k: int = 20,
                    max_users: int = 2048, seed: int = 0,
                    device="cuda") -> dict:
    """Recall/NDCG@k of an artifact's scoring function on held-out
    edges, streaming item blocks (never a dense users x items)."""
    from repro_torch.models import lightgcn as L
    from repro_torch.training.eval import recall_ndcg_at_k, topk_streaming
    tu, ti = test_edges
    mcfg = artifact.mcfg()
    keep = tu < mcfg.n_users          # frozen artifacts don't know late users
    users = np.unique(tu[keep])
    if users.size == 0:
        return {"recall": 0.0, "ndcg": 0.0, "n_users": 0}
    if users.size > max_users:
        users = np.sort(np.random.default_rng(seed).choice(
            users, max_users, replace=False))
    statics = artifact.statics(device=device)
    params = {key: torch.as_tensor(np.asarray(v), device=device)
              for key, v in artifact.params.items()}
    u_emb, v_all = L.eval_embeddings(
        params, statics, mcfg, torch.as_tensor(users, device=device))
    eu = np.asarray(artifact.edges["edge_u"])
    ev = np.asarray(artifact.edges["edge_v"])
    m = np.isin(eu, users)
    rows = np.searchsorted(users, eu[m]).astype(np.int32)
    topk = topk_streaming(u_emb, v_all, k, block=4096,
                          exclude=(rows, ev[m].astype(np.int32)))
    # score ALL held-out edges (unknown users/items count as misses for
    # a system that cannot serve them — that is the frozen penalty)
    return recall_ndcg_at_k(topk, tu, ti, users, k=k)


def _extend_users(artifact, n_users: int):
    """The frozen baseline: the warm artifact force-fed late users by
    pointing them at codebook row 0. Items stay at the warm count: a
    frozen system cannot recommend items it does not know."""
    from repro_torch.core.sketch import Sketch
    from repro_torch.serve import CompressedArtifact
    sk = artifact.sketch
    pad = np.zeros((n_users - sk.user_idx.shape[0], sk.user_idx.shape[1]),
                   sk.user_idx.dtype)
    sk2 = Sketch(np.concatenate([sk.user_idx, pad]), sk.item_idx,
                 sk.k_users, sk.k_items, method=sk.method + "+frozen")
    model = dict(artifact.model)
    model["n_users"] = int(n_users)
    return CompressedArtifact(params=artifact.params, edges=artifact.edges,
                              sketch=sk2, model=model,
                              provenance=dict(artifact.provenance,
                                              frozen=True))


def bench(n_users=1800, n_items=1440, k_true=24, avg_deg=12, T=4, dim=32,
          base_steps=300, full_steps=400, tune_steps=60, refresh_every=2,
          drift=0.05, holdout=0.1, k=20, seed=0, log=print, device="cuda"):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.device import resolve_device
    from repro_torch.stream import ReplayConfig, StreamUpdater, replay
    from repro_torch.training import TrainConfig, Trainer

    dev = resolve_device(device)
    stream = drifting_coclusters(n_users, n_items, k_true, avg_deg, T=T,
                                 drift=drift, seed=seed)
    train_steps, tu, tv = _split_steps(stream.steps, holdout, seed)
    engine = ClusterEngine(device=dev)

    # --- bootstrap on the warm prefix --------------------------------------
    log(f"[stream_bench] warm prefix {stream.n_warm_users}x"
        f"{stream.n_warm_items} ({stream.base.n_edges} edges), "
        f"{T} steps to {n_users}x{n_items}")
    sketch = engine.build(stream.base, d=dim, ratio=0.25)
    tr = Trainer(stream.base, sketch,
                 TrainConfig(dim=dim, steps=base_steps, batch_size=1024,
                             lr=5e-3, seed=seed), device=dev)
    tr.run(log_every=0)
    frozen_art = tr.export()
    # exact end-of-stream maxima: a loose edge bound would round to a
    # needlessly high power-of-two rung and tax every padded op
    edge_bound = stream.base.n_edges + sum(s.edge_u.size
                                           for s in train_steps)
    stream_caps = {"n_users": n_users, "n_items": n_items,
                   "k_users": sketch.k_users + n_users - stream.n_warm_users,
                   "k_items": sketch.k_items + n_items - stream.n_warm_items,
                   "n_edges": edge_bound}
    updater = StreamUpdater.from_trainer(tr, engine=engine,
                                         capacity=stream_caps)
    session = frozen_art.session(k=k, capacity=stream_caps, scorer=SCORER,
                                 device=dev)
    session.warmup(8)
    allocated = session.state_allocations

    # --- replay ------------------------------------------------------------
    t0 = clock.now()
    report = replay(updater, train_steps, session,
                    ReplayConfig(refresh_every=refresh_every,
                                 tune_steps=tune_steps,
                                 requests_per_step=4, request_batch=8,
                                 seed=seed),
                    log=log)
    _sync(dev)
    replay_s = clock.now() - t0
    stream_art = report["final_artifact"]
    tele = report["telemetry"]
    maintenance_s = (report["refresh_total_ms"] + report["tune_total_ms"]
                     + report["cold_assign_total_ms"]) / 1e3

    # --- full re-solve reference over the final graph ----------------------
    final_graph = updater.sgraph.graph
    t0 = clock.now()
    full_sketch = engine.build(final_graph, d=dim, ratio=0.25)
    tr_full = Trainer(final_graph, full_sketch,
                      TrainConfig(dim=dim, steps=full_steps,
                                  batch_size=1024, lr=5e-3, seed=seed),
                      device=dev)
    tr_full.run(log_every=0)
    _sync(dev)
    full_s = clock.now() - t0
    full_art = tr_full.export()

    # --- recall on held-out stream edges -----------------------------------
    tu_c, tv_c = _drop_seen(tu, tv, final_graph)
    test = (tu_c, tv_c)
    rec_frozen = artifact_recall(_extend_users(frozen_art, n_users), test,
                                 k=k, seed=seed, device=dev)
    rec_stream = artifact_recall(stream_art, test, k=k, seed=seed,
                                 device=dev)
    rec_full = artifact_recall(full_art, test, k=k, seed=seed, device=dev)
    gap = rec_full["recall"] - rec_frozen["recall"]
    recovered = (rec_stream["recall"] - rec_frozen["recall"]) / gap \
        if gap > 1e-9 else float("nan")
    events = report["refresh_events_ms"]
    # steady-state re-grouping cost: the LAST event, once every buffer of
    # the capacity ladder exists
    steady_s = (events[-1] / 1e3) if events else float("nan")
    record = {
        "config": {"n_users": n_users, "n_items": n_items,
                   "k_true": k_true, "T": T, "dim": dim, "drift": drift,
                   "base_steps": base_steps, "full_steps": full_steps,
                   "tune_steps": tune_steps,
                   "refresh_every": refresh_every, "seed": seed},
        "scorer": SCORER,
        "cold_assign_first_ms": report["cold_assign_first_ms"],
        "cold_assign_warm_p50_ms": report["cold_assign_warm_p50_ms"],
        "swap_p50_ms": tele["swap_p50_ms"],
        "swap_p99_ms": tele["swap_p99_ms"],
        "swaps": tele["swaps"],
        "capacity_bumps": tele["capacity_bumps"],
        "swap_state_allocations": session.state_allocations - allocated,
        "delta_bytes_mean": report["delta_bytes_mean"],
        "refresh_total_s": round(report["refresh_total_ms"] / 1e3, 3),
        "tune_total_s": round(report["tune_total_ms"] / 1e3, 3),
        "refresh_events_s": [round(ms / 1e3, 3) for ms in events],
        "refresh_steady_s": round(steady_s, 3),
        "refresh_steady_frac_of_full": round(steady_s / full_s, 4),
        "maintenance_s": round(maintenance_s, 3),
        "replay_s": round(replay_s, 3),
        "full_resolve_s": round(full_s, 3),
        "maintenance_frac_of_full": round(maintenance_s / full_s, 4),
        "recall_frozen": round(rec_frozen["recall"], 4),
        "recall_stream": round(rec_stream["recall"], 4),
        "recall_full": round(rec_full["recall"], 4),
        "recall_gap_recovered": round(recovered, 4),
        "churn_mean": tele["churn_mean"],
        "n_test_edges": int(tu_c.size),
    }
    log(f"[stream_bench] recall frozen={record['recall_frozen']} "
        f"stream={record['recall_stream']} full={record['recall_full']} "
        f"-> gap recovered {record['recall_gap_recovered']}; refresh "
        f"steady {record['refresh_steady_s']}s = "
        f"{100 * record['refresh_steady_frac_of_full']:.0f}% of full "
        f"re-solve ({record['full_resolve_s']}s; total maintenance "
        f"{record['maintenance_s']}s = "
        f"{100 * record['maintenance_frac_of_full']:.0f}%); swap p99 "
        f"{record['swap_p99_ms']}ms, swap allocations="
        f"{record['swap_state_allocations']}")
    return record


def stream_metrics(record) -> dict:
    """Declared-direction headline metrics of the stream record: the
    reference's, plus ``swap_state_allocations`` where the port's record
    carries it in place of ``compiles``."""
    out = {}
    for key, make in (("cold_assign_first_ms", lower),
                      ("cold_assign_warm_p50_ms", lower),
                      ("swap_p50_ms", lower),
                      ("swap_p99_ms", lower),
                      ("refresh_total_s", lower),
                      ("tune_total_s", lower),
                      ("refresh_steady_frac_of_full", lower),
                      ("maintenance_frac_of_full", lower),
                      ("recall_frozen", higher),
                      ("recall_stream", higher),
                      ("recall_full", higher),
                      ("recall_gap_recovered", higher),
                      ("compiles", lower),
                      ("swap_state_allocations", lower),
                      ("capacity_bumps", lower)):
        v = record.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool) \
                and v == v:                    # NaN never gates
            out[key] = make(v)
    return out


def main(argv=None):
    run = BenchRun("stream", description=__doc__)
    run.add_argument("--n-users", type=int, default=1800)
    run.add_argument("--n-items", type=int, default=1440)
    run.add_argument("--k-true", type=int, default=24)
    run.add_argument("--steps", dest="T", type=int, default=4)
    run.add_argument("--dim", type=int, default=32)
    run.add_argument("--base-steps", type=int, default=300)
    run.add_argument("--full-steps", type=int, default=400)
    run.add_argument("--tune-steps", type=int, default=60)
    run.add_argument("--refresh-every", type=int, default=2)
    run.add_argument("--drift", type=float, default=0.05,
                     help="membership drift per stream step (the regime "
                          "warm refresh targets; heavy drift is a "
                          "rebuild)")
    run.add_argument("--seed", type=int, default=0)
    args = run.parse(argv)
    config = {"n_users": args.n_users, "n_items": args.n_items,
              "k_true": args.k_true, "T": args.T, "dim": args.dim,
              "base_steps": args.base_steps,
              "full_steps": args.full_steps,
              "tune_steps": args.tune_steps,
              "refresh_every": args.refresh_every, "drift": args.drift,
              "seed": args.seed}
    hit = run.cached(config)
    if hit is not None:
        run.replay(hit)
        return 0
    dev = run.device
    with run.profile("replay"):
        record = {"bench": "stream", "platform": dev.type,
                  "device": (torch.cuda.get_device_name(dev)
                             if dev.type == "cuda" else "cpu"),
                  **bench(n_users=args.n_users, n_items=args.n_items,
                          k_true=args.k_true, T=args.T, dim=args.dim,
                          base_steps=args.base_steps,
                          full_steps=args.full_steps,
                          tune_steps=args.tune_steps,
                          refresh_every=args.refresh_every,
                          drift=args.drift, seed=args.seed,
                          log=(lambda *_: None) if args.json else print,
                          device=dev)}
    run.emit(config, stream_metrics(record), record)
    return 0


if __name__ == "__main__":
    sys.exit(main())

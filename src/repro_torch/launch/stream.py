"""Streaming launcher for the port: ``python -m repro_torch.launch.stream``
(the reference's ``repro.launch.stream``, on the GPU).

Replays an interaction stream through the online co-clustering and
hot-swap serving stack (``repro_torch.stream``), in one process:

    bootstrap   cluster + train the warm prefix, export the artifact,
                open a capacity-padded RecsysSession
    per step    append arriving edges -> cold-assign new users/items
                (one LP half-step over their incident edges) ->
                periodically refresh (budgeted warm re-solve + short
                fine-tune) -> publish a delta -> hot-swap the session
                between requests (no device allocation under the
                capacity ladder)

The stream is the drifting planted-co-cluster generator
(``repro_torch.data.drifting_coclusters``); ``--artifact DIR`` also
publishes the final bundle. Runs on the CUDA device by default
(``--device cpu`` runs the kernels' plain versions on the CPU). Under
``torchrun`` every rank joins the launcher's ``torch.distributed`` world
and the solves shard over it ("torch_sharded"); run alone,
``--cluster-solver torch_sharded`` runs on a world of 1.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-users", type=int, default=1200)
    ap.add_argument("--n-items", type=int, default=960)
    ap.add_argument("--k-true", type=int, default=20)
    ap.add_argument("--avg-deg", type=int, default=10)
    ap.add_argument("--t-steps", type=int, default=4,
                    help="stream steps (arrival waves)")
    ap.add_argument("--drift", type=float, default=0.08,
                    help="fraction of users migrating cluster per step")
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--steps", type=int, default=200,
                    help="BPR steps for the warm bootstrap train")
    ap.add_argument("--tune-steps", type=int, default=40,
                    help="fine-tune steps per refresh")
    ap.add_argument("--refresh-every", type=int, default=2,
                    help="refresh cadence in stream steps (0 disables)")
    ap.add_argument("--requests-per-step", type=int, default=8,
                    help="serving requests issued between event batches")
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cluster-solver", default="auto",
                    help="ClusterEngine solver: auto | torch | "
                         "torch_sharded | torch_streamed | torch_hostloop "
                         "| numpy (auto picks torch_sharded on a world of "
                         "several ranks)")
    ap.add_argument("--artifact", default=None,
                    help="publish the final artifact here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import normalize_solver
    from repro_torch.distributed import entry_world
    try:
        solver = normalize_solver(args.cluster_solver)
    except KeyError as e:
        ap.error(str(e.args[0]))
    with entry_world(args.device, solver == "torch_sharded") as device:
        return _replay(args, solver, device)


def _replay(args, solver, device):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import drifting_coclusters
    from repro_torch.stream import ReplayConfig, StreamUpdater, replay
    from repro_torch.training import TrainConfig, Trainer

    stream = drifting_coclusters(args.n_users, args.n_items, args.k_true,
                                 args.avg_deg, T=args.t_steps,
                                 drift=args.drift, seed=args.seed)
    engine = ClusterEngine(solver=solver, device=str(device))
    print(f"[stream] warm prefix {stream.n_warm_users}x"
          f"{stream.n_warm_items} ({stream.base.n_edges} edges); "
          f"{args.t_steps} waves to {args.n_users}x{args.n_items} "
          f"on {device}")
    sketch = engine.build(stream.base, d=args.dim, ratio=0.25)
    tr = Trainer(stream.base, sketch,
                 TrainConfig(dim=args.dim, steps=args.steps,
                             batch_size=1024, lr=5e-3, seed=args.seed),
                 device=device)
    tr.run(log_every=0)
    art = tr.export()
    print(f"[stream] bootstrap: {sketch.k_users}+{sketch.k_items} codebook "
          f"rows, gamma={sketch.meta['gamma']:.3g}")

    caps = {"n_users": args.n_users, "n_items": args.n_items,
            "k_users": args.n_users // 2, "k_items": args.n_items // 2,
            "n_edges": stream.base.n_edges
            + sum(s.edge_u.size for s in stream.steps)}
    # capacity-padded refresh solves run the in-memory solver; a pinned
    # solver other than "torch" must really be used, so it forgoes them
    # (the reference's rule)
    updater_caps = caps if solver in (None, "torch") else None
    if updater_caps is None:
        print(f"[stream] note: --cluster-solver={args.cluster_solver} "
              f"pins refresh solves to that solver; capacity-stable "
              f"refresh needs the torch solver")
    updater = StreamUpdater.from_trainer(tr, engine=engine,
                                         capacity=updater_caps)
    session = art.session(k=args.k, capacity=caps, device=device)
    session.warmup(8)
    allocated = session.state_allocations

    report = replay(updater, stream.steps, session,
                    ReplayConfig(refresh_every=args.refresh_every,
                                 tune_steps=args.tune_steps,
                                 requests_per_step=args.requests_per_step,
                                 request_batch=8, seed=args.seed),
                    log=lambda s: print(f"[stream] {s}"))
    final = report["final_artifact"]
    tele = report["telemetry"]
    print(f"[stream] done: {tele['appends']} appends "
          f"(+{tele['cold_users']} users, +{tele['cold_items']} items, "
          f"+{tele['new_edges']} edges), {tele['refreshes']} refreshes "
          f"(mean churn {tele['churn_mean']}), {tele['swaps']} swaps "
          f"p99={tele['swap_p99_ms']}ms, cold-assign "
          f"first={report['cold_assign_first_ms']}ms / "
          f"warm p50={report['cold_assign_warm_p50_ms']}ms, "
          f"swap allocations="
          f"{session.state_allocations - allocated}, mean delta "
          f"{report['delta_bytes_mean'] // 1024}KB")
    print(f"[stream] serving telemetry: {session.stats()}")
    if args.artifact:
        path = final.save(args.artifact)
        print(f"[stream] published final artifact to {path} "
              f"(id {final.content_id()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

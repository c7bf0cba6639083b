"""Training launcher for the port: ``python -m repro_torch.launch.train``
(port of ``repro.launch.train``'s paper pipeline).

BACO-compresses a synthetic interaction graph with the port's
ClusterEngine (``--method baco``; ``full`` trains uncompressed tables),
trains LightGCN + BPR with checkpoint/resume, prints Recall/NDCG@20 on
the held-out edges, and with ``--export DIR`` publishes the trained
CompressedArtifact (``python -m repro_torch.launch.serve --artifact DIR``
serves it, as does the JAX package).

Fault-tolerance knobs:
  --resume            resume from the newest checkpoint in --ckpt-dir
  --step-timeout S    if 50 steps take more than 50 x S seconds,
                      checkpoint and exit(17) so a cluster runner can
                      relaunch elsewhere

Runs on the CUDA device by default (``--device cpu`` runs the kernels'
plain versions on the CPU). The other sketch methods and ``--arch`` are
not ported yet and raise.
"""
from __future__ import annotations

import argparse
import sys
import time


def paper_pipeline(args):
    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import TrainConfig, Trainer

    if args.method not in ("baco", "full"):
        raise NotImplementedError(
            f"--method {args.method!r} is not ported yet (baco and full "
            f"are)")
    g, uc, ic, train, test = paperlike_dataset(args.dataset, seed=args.seed)
    print(f"[train] dataset={args.dataset}: {train.n_users} users, "
          f"{train.n_items} items, {train.n_edges} edges")
    if args.method == "full":
        sketch = None
    else:
        sketch = ClusterEngine(device=args.device).build(
            train, d=args.dim, ratio=args.ratio)
    cfg = TrainConfig(dim=args.dim, steps=args.steps,
                      batch_size=args.batch_size, lr=args.lr,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      seed=args.seed, backend=args.trainer_backend,
                      chunk_size=args.chunk_size, sampler=args.sampler)
    tr = Trainer(train, sketch, cfg, device=args.device)
    print(f"[train] backend={tr.backend.name} sampler={tr.sampler.name} "
          f"chunk={cfg.chunk_size} device={tr.device}")
    if args.resume and tr.maybe_resume():
        print(f"[train] resumed at step {tr.step}")
    t_start = time.time()
    step_t0 = time.time()
    while tr.step < cfg.steps:
        tr.run(steps=min(tr.step + 50, cfg.steps), log_every=0)
        dt = time.time() - step_t0
        if args.step_timeout and dt > args.step_timeout * 50:
            print(f"[train] straggler detected ({dt:.1f}s for 50 steps): "
                  f"checkpointing and exiting for relaunch")
            if tr.ckpt is not None:
                tr._maybe_checkpoint(force=True)
            return 17
        step_t0 = time.time()
    m = tr.evaluate(test)
    print(f"[train] method={args.method} params={tr.n_params()} "
          f"recall@20={m['recall']:.4f} ndcg@20={m['ndcg']:.4f} "
          f"({time.time() - t_start:.1f}s)")
    if args.export:
        tr.export(args.export)
        print(f"[train] exported artifact to {args.export}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="not ported yet (the LM/recsys architectures)")
    ap.add_argument("--dataset", default="gowalla_s")
    ap.add_argument("--method", default="baco",
                    help="baco | full (the other sketch methods are not "
                         "ported yet)")
    ap.add_argument("--ratio", type=float, default=0.25)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch-size", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--step-timeout", type=float, default=0)
    ap.add_argument("--trainer-backend", default="auto",
                    help="trainer backend: auto | host (per-step host "
                         "sync) | fused (chunks with no host sync)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="steps per chunk (fused backend)")
    ap.add_argument("--sampler", default=None, choices=["numpy", "device"],
                    help="BPR sampler (default: the backend's own)")
    ap.add_argument("--export", default=None,
                    help="publish the trained CompressedArtifact here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.arch:
        raise NotImplementedError(
            f"--arch {args.arch!r} is not ported yet: the port trains the "
            f"paper pipeline (LightGCN + BPR) only")
    return paper_pipeline(args)


if __name__ == "__main__":
    sys.exit(main())

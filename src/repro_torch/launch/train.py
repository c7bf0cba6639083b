"""Training launcher for the port: ``python -m repro_torch.launch.train``
(port of ``repro.launch.train``).

Two modes:
  * paper pipeline (default), below;
  * ``--arch <id> [--shape train_batch]``: N train steps of an
    architecture's cell (``launch.steps.build_cell``: DLRM, Wide&Deep,
    SASRec, BERT4Rec, ``lightgcn-baco``'s ``bpr_train``, an LM's
    ``train_4k`` (gemma2-9b, gemma3-12b, qwen1.5-32b, dbrx-132b,
    kimi-k2-1t-a32b; an LM's shape defaults to it), or SchNet's
    ``full_graph_sm``, ``minibatch_lg``, ``ogb_products`` and
    ``molecule``), at smoke width (the full width runs through
    ``build_cell(..., smoke=False)`` with ``LM_ONE_CARD`` /
    ``GNN_ONE_CARD``'s cuts).

Compresses a synthetic interaction graph — BACO through the port's
ClusterEngine (``--method baco``, solver ``--cluster-solver``), any other
ETC baseline of ``core.BASELINES`` through ``build_sketch`` (its LP
builders solve on ``--device``), or ``full`` for uncompressed tables —
trains LightGCN + BPR with checkpoint/resume, prints the embedding
parameters and Recall/NDCG@20 on the held-out edges, and with
``--export DIR`` publishes the trained CompressedArtifact (``python -m
repro_torch.launch.serve --artifact DIR`` serves it, as does the JAX
package).

Fault-tolerance knobs:
  --resume            resume from the newest checkpoint in --ckpt-dir
  --step-timeout S    if 50 steps take more than 50 x S seconds,
                      checkpoint and exit(17) so a cluster runner can
                      relaunch elsewhere

Runs on the CUDA device by default (``--device cpu`` runs the kernels'
plain versions on the CPU).

Several ranks: under ``torchrun`` every rank joins the launcher's
``torch.distributed`` world (NCCL on ``--device cuda``, each rank on the
card of its ``LOCAL_RANK``; gloo on ``--device cpu``), auto-selection
then picks the "torch_sharded" solver, and ``--trainer-backend
fused_sharded`` trains data parallel; rank 0 alone checkpoints and
exports. Run alone, a sharded solver or trainer runs on a world of 1:

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --trainer-backend fused_sharded
"""
from __future__ import annotations

import argparse
import sys
import time


def paper_pipeline(args):
    from repro_torch.distributed import entry_world
    sharded = (args.cluster_solver == "torch_sharded"
               or args.trainer_backend == "fused_sharded")
    with entry_world(args.device, sharded) as device:
        return _paper_pipeline(args, device)


def _paper_pipeline(args, device):
    import torch.distributed as dist

    from repro_torch.core import ClusterEngine, build_sketch, normalize_solver
    from repro_torch.data import paperlike_dataset
    from repro_torch.training import TrainConfig, Trainer

    rank = dist.get_rank() if dist.is_initialized() else 0
    g, uc, ic, train, test = paperlike_dataset(args.dataset, seed=args.seed)
    print(f"[train] dataset={args.dataset}: {train.n_users} users, "
          f"{train.n_items} items, {train.n_edges} edges")
    if args.method == "full":
        sketch = None
    elif args.method == "baco":
        engine = ClusterEngine(solver=normalize_solver(args.cluster_solver),
                               device=str(device))
        sketch = engine.build(train, d=args.dim, ratio=args.ratio,
                              batched_gamma=args.batched_gamma)
    else:
        sketch = build_sketch(args.method, train,
                              budget=int(args.ratio * train.n_nodes),
                              device=device)
    if sketch is not None:
        solver = (sketch.meta or {}).get("solver")
        print(f"[train] sketch {sketch.method}"
              + (f" (solver {solver})" if solver else "")
              + f": K_u={sketch.k_users} "
              f"K_v={sketch.k_items} ({sketch.n_params(args.dim)} params, "
              f"{sketch.compression_ratio(args.dim) * 100:.1f}% of full)")
    cfg = TrainConfig(dim=args.dim, steps=args.steps,
                      batch_size=args.batch_size, lr=args.lr,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                      seed=args.seed, backend=args.trainer_backend,
                      chunk_size=args.chunk_size, sampler=args.sampler)
    tr = Trainer(train, sketch, cfg, device=device)
    world = (f" rank={rank}/{dist.get_world_size()}"
             if dist.is_initialized() else "")
    print(f"[train] backend={tr.backend.name} sampler={tr.sampler.name} "
          f"chunk={cfg.chunk_size} device={tr.device}{world}")
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
    if args.export and rank == 0:
        tr.export(args.export)
        print(f"[train] exported artifact to {args.export}")
    return 0


def arch_pipeline(args):
    from repro_torch.launch.steps import build_cell
    from repro_torch.obs import clock
    cell = build_cell(args.arch, args.shape, smoke=True, device=args.device)
    out = cell.fn(*cell.args)
    t0 = clock.now()
    for _ in range(args.steps):
        out = cell.fn(*cell.args)
    loss = out[2] if cell.kind == "train" else None
    if loss is not None:
        loss = float(loss)             # waits for the device
    dt = clock.now() - t0
    print(f"[train] {args.arch}:{args.shape} x{args.steps} smoke steps "
          f"on {args.device} in {dt:.2f}s"
          + (f" loss={loss:.4f}" if loss is not None else ""))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="train an architecture's cell (configs.list_archs)")
    ap.add_argument("--shape", default="train_batch")
    ap.add_argument("--dataset", default="gowalla_s")
    ap.add_argument("--method", default="baco",
                    help="full, or an ETC method of core.BASELINES (baco, "
                         "random, double, lp, louvain_modularity, ...)")
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
                         "sync) | fused (chunks with no host sync) | "
                         "fused_sharded (data parallel over the ranks of "
                         "the torch.distributed world)")
    ap.add_argument("--chunk-size", type=int, default=16,
                    help="steps per chunk (fused backends)")
    ap.add_argument("--sampler", default=None, choices=["numpy", "device"],
                    help="BPR sampler (default: the backend's own)")
    ap.add_argument("--export", default=None,
                    help="publish the trained CompressedArtifact here")
    ap.add_argument("--cluster-solver", default="auto",
                    help="ClusterEngine solver for --method baco: auto | "
                         "torch | torch_sharded | torch_streamed | "
                         "torch_hostloop | numpy (auto picks torch_sharded "
                         "on a world of several ranks)")
    ap.add_argument("--batched-gamma", action="store_true",
                    help="solve the gamma grid in blocks of lanes "
                         "(identical selection to the sequential walk)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    # validate against the live registries before any work
    from repro_torch.core import BASELINES, normalize_solver
    if args.method != "full" and args.method not in BASELINES:
        ap.error(f"unknown --method {args.method!r}; choose full or one of "
                 f"{sorted(BASELINES)}")
    try:
        normalize_solver(args.cluster_solver)
    except KeyError as e:
        ap.error(str(e.args[0]))
    if args.arch:
        from repro_torch.configs.registry import get_arch
        if get_arch(args.arch).family == "lm" and args.shape == "train_batch":
            args.shape = "train_4k"           # the reference's LM default
        return arch_pipeline(args)
    return paper_pipeline(args)


if __name__ == "__main__":
    sys.exit(main())

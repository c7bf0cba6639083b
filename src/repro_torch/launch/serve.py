"""Serving launcher for the port: ``python -m repro_torch.launch.serve``.

``--artifact DIR`` serves a published CompressedArtifact bundle (one the
JAX package exported loads as well; ``python -m repro_torch.launch.train
--export DIR`` publishes a trained one). Without one, the launcher builds
the BACO sketch on the spot with the port's ClusterEngine and serves
randomly initialised codebooks (seeded), so the top-k lists are
untrained. Requests go through RecsysSession behind BatchDispatcher; the
launcher prints p50/p99 latency.

For the architectures, ``--arch <id> --shape <shape>`` serves the cell
through ``ArchSession``: a recsys arch's serve_p99|serve_bulk|
retrieval_cand, or an LM's (gemma2-9b, gemma3-12b, qwen1.5-32b, and the
MoE LMs dbrx-132b and kimi-k2-1t-a32b) prefill_32k|decode_32k (gemma's
long_500k too), at smoke width (the published width runs through
``ArchSession(..., smoke=False)``). It prints p50/p99 and, for the LM
cells, tokens/s.

Runs on the CUDA device by default (``--device cpu`` to run the kernels'
plain versions on the CPU).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _get_artifact(args):
    from repro_torch.serve import CompressedArtifact
    if args.artifact:
        try:
            art = CompressedArtifact.load(args.artifact)
            print(f"[serve] loaded artifact {args.artifact} "
                  f"(method={art.provenance.get('method', '?')}, "
                  f"{art.n_params()} params)")
            return art
        except FileNotFoundError:
            pass
    from repro_torch.core import ClusterEngine
    from repro_torch.data import paperlike_dataset
    from repro_torch.models.lightgcn import (edge_norms, from_sketch,
                                            init_params)
    _, _, _, train, _ = paperlike_dataset(args.dataset, seed=args.seed)
    engine = ClusterEngine(device=args.device)
    sketch = engine.build(train, d=args.dim, ratio=0.25)
    print(f"[serve] built sketch on {args.device}: K_u={sketch.k_users} "
          f"K_v={sketch.k_items} gamma={sketch.meta['gamma']} "
          f"iters={sketch.meta['iters']} {engine.stats}")
    print("[serve] no trained artifact given: serving randomly "
          f"initialised codebooks (seed {args.seed})")
    mcfg = from_sketch(train, sketch, dim=args.dim)
    art = CompressedArtifact.from_parts(
        init_params(args.seed, mcfg), {"edge_u": train.edge_u,
                                       "edge_v": train.edge_v,
                                       "edge_norm": edge_norms(train)},
        sketch, mcfg, {"params": f"init_params(seed={args.seed})"})
    if args.artifact:
        art.save(args.artifact)
        print(f"[serve] exported artifact to {args.artifact}")
    return art


def arch_serving(args):
    from repro_torch.embedding import normalize_backend
    from repro_torch.serve import ArchSession
    session = ArchSession(args.arch, args.shape,
                          backend=normalize_backend(args.backend),
                          smoke=True, device=args.device)
    session.warmup()
    for _ in range(args.n_requests):
        session()
    st = session.stats()
    rate = (f" tokens/s={st['tokens_per_s']:.1f}"
            if "tokens_per_s" in st else "")
    print(f"[serve] {args.arch}:{args.shape} "
          f"smoke on {args.device} "
          f"(backend={args.backend}): {st['requests']} requests "
          f"p50={st['p50_ms']:.2f}ms p99={st['p99_ms']:.2f}ms{rate}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="gowalla_s")
    ap.add_argument("--arch", default=None,
                    help="serve an architecture's cell (configs.list_archs)")
    ap.add_argument("--shape", default="serve_p99")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--k", type=int, default=20)
    ap.add_argument("--n-requests", type=int, default=50)
    ap.add_argument("--artifact", default=None,
                    help="artifact dir: load if published, else build and "
                         "export here")
    ap.add_argument("--buckets", default="1,8,64,512",
                    help="BatchDispatcher bucket ladder (comma-separated)")
    ap.add_argument("--randomize-batches", action="store_true",
                    help="draw each request's batch size from [1, top "
                         "bucket] instead of --batch")
    ap.add_argument("--backend", default="auto",
                    help="lookup backend override (gather|cuda; auto keeps "
                         "the artifact's choice)")
    ap.add_argument("--scorer", default="auto",
                    help="top-k readout: dense (auto) or fused")
    ap.add_argument("--quantize", action="store_true",
                    help="serve the int8 quantized copy of the artifact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.embedding import normalize_backend
    from repro_torch.serve import BatchDispatcher, RecsysSession
    from repro_torch.serve.session import normalize_scorer
    for fn, value in ((normalize_backend, args.backend),
                      (normalize_scorer, args.scorer)):
        try:
            fn(value)
        except (KeyError, ValueError) as e:
            ap.error(str(e.args[0] if e.args else e))
    if args.arch:
        return arch_serving(args)
    art = _get_artifact(args)
    if args.quantize:
        art = art.quantize()
    session = RecsysSession.from_artifact(
        art, k=args.k, backend=normalize_backend(args.backend),
        scorer=args.scorer, device=args.device)
    disp = BatchDispatcher(
        session, buckets=tuple(int(b) for b in args.buckets.split(",")))
    disp.warmup()
    rng = np.random.default_rng(args.seed)
    n_users = art.model["n_users"]
    top = disp.buckets[-1]
    for _ in range(args.n_requests):
        size = (int(rng.integers(1, top + 1)) if args.randomize_batches
                else args.batch)
        disp(rng.integers(0, n_users, size))
    st = disp.stats()
    sk = art.sketch
    compression = (f"codebook {sk.k_users}+{sk.k_items} rows, "
                   f"{sk.compression_ratio(art.model['dim'])*100:.0f}% "
                   f"of full params" if sk is not None else "uncompressed")
    print(f"[serve] {st['requests']} requests on {args.device} "
          f"(batch={'rand' if args.randomize_batches else args.batch}, "
          f"scorer={session.scorer}, int8={args.quantize}): "
          f"p50={st['p50_ms']:.2f}ms p99={st['p99_ms']:.2f}ms "
          f"buckets={st['bucket_counts']} ({compression}; "
          f"{art.serving_nbytes()} bytes of tables)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

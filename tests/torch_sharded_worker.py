"""One gloo rank of ``tests/test_torch_sharded.py``'s 4-rank world.

    python tests/torch_sharded_worker.py RANK WORLD STORE_FILE OUT_DIR

Every rank joins the world through a file store, runs every case of the
multi-rank tests through the port's public entry points (the sharded
solve, auto-selection, the sharded sketch build, fused vs fused_sharded
training, the trainer's refusals, the compressed gradient mean) and
pickles what it saw to ``OUT_DIR/rank<RANK>.pkl``; the test process
compares those with the JAX package. Imports nothing of JAX.
"""
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

# (gamma, budget) of the reference's mesh-of-4 parity test
SOLVE_CASES = ((1.0, None), (4.0, 135), (16.0, None))
TRAIN = dict(dim=16, steps=12, batch_size=256, lr=5e-3, chunk_size=4)


def planted():
    from repro_torch.core import make_weights
    from repro_torch.data import planted_coclusters
    g, _, _ = planted_coclusters(300, 240, k_true=12, avg_deg=10, seed=0)
    return g, make_weights(g, "hws")


def compress_grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.standard_normal(512) * (rank + 1)).astype(np.float32),
            "b": rng.standard_normal((16, 8)).astype(np.float32)}


def run(rank: int, world: int) -> dict:
    from repro_torch.core import ClusterEngine
    from repro_torch.core.solver_sharded import lp_solve_sharded
    from repro_torch.distributed import cluster_mesh, data_mesh, use_mesh
    from repro_torch.training import TrainConfig, Trainer
    from repro_torch.training.compress import mean_grads_compressed

    out = {}
    g, (wu, wv) = planted()
    mesh = cluster_mesh(world, device="cpu")
    out["solve"] = {case: lp_solve_sharded(g, wu, wv, case[0], case[1], 8,
                                           mesh=mesh, device="cpu")
                    for case in SOLVE_CASES}
    out["auto"] = ClusterEngine(device="cpu").resolve().name
    sk = ClusterEngine(solver="torch_sharded", device="cpu").build(
        g, d=16, ratio=0.3)
    out["sketch"] = (sk.user_idx, sk.item_idx, sk.meta["gamma"])

    # the test holds sk to the reference's sketch, which both trainers use
    for backend in ("fused", "fused_sharded"):
        tr = Trainer(g, sk, TrainConfig(backend=backend, **TRAIN),
                     device="cpu")
        losses = tr.run(log_every=0)
        out[backend] = (losses, {k: v.detach().numpy().copy()
                                 for k, v in tr.params.items()})
    for name, cfg in (("indivisible", dict(TRAIN, batch_size=254)),
                      ("n_devices", dict(TRAIN, n_devices=world + 1))):
        try:
            Trainer(g, sk, TrainConfig(backend="fused_sharded", **cfg),
                    device="cpu")
            out[name] = None
        except ValueError as e:
            out[name] = str(e)

    grads = compress_grads(rank)
    with use_mesh(data_mesh(device="cpu")):
        out["mean"] = {m: {k: v.numpy() for k, v in mean_grads_compressed(
            {k: torch.from_numpy(v) for k, v in grads.items()}, m).items()}
            for m in ("bf16", "int8")}
    return out


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, out_dir = argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = run(rank, world)
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

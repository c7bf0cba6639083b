"""One gloo rank of ``tests/test_torch_dryrun.py``'s reckoning check.

    python tests/torch_op_analysis_worker.py RANK WORLD STORE_FILE OUT_JSON

Every rank joins a world of ``WORLD`` ranks through a file store, builds
each cell of ``CELLS`` at smoke width on the (2, 2) ("data", "model")
mesh on the CPU with the "cuda" lookup backend (the kernels' plain
versions behind the wrappers the card runs), and runs its step once
under ``launch.op_analysis``. Rank 0 writes its counts, by cell, to
``OUT_JSON``. Imports nothing of JAX.
"""
import json
import sys

import torch
import torch.distributed as dist

CELLS = (("gemma2-9b", "train_4k"), ("dlrm-mlperf-baco", "serve_p99"))
MESH = ((2, 2), ("data", "model"))


def count_cell(arch: str, shape: str, device: str) -> dict:
    """(op metrics, memory analysis) of this rank's step of the smoke
    cell on the (2, 2) mesh over the open world, on ``device`` ("cpu",
    or "meta" for the reckoning)."""
    from repro_torch.launch import op_analysis, steps
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MESH, device="cpu")
    cell = steps.build_cell(arch, shape, mesh=mesh, smoke=True,
                            device=device, lookup_backend="cuda")
    _, metrics, memory = op_analysis.count(cell.fn, *cell.args)
    return {"metrics": metrics, "memory": memory}


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        got = {f"{a}:{s}": count_cell(a, s, "cpu") for a, s in CELLS}
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

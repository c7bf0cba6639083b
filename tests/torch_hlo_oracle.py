"""The JAX package's compiled per-device metrics of the smoke cells that
``tests/test_torch_dryrun.py`` reckons on a (2, 2) mesh.

    python tests/torch_hlo_oracle.py OUT.json

Run as a script, it sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``JAX_PLATFORMS=cpu`` before importing jax, builds the (2, 2)
``("data", "model")`` mesh as ``tests/torch_mesh_oracle.py`` does
(``jax.sharding.Mesh``, Auto axes), and for each cell of
``torch_op_analysis_worker.CELLS`` lowers and compiles the reference's
smoke cell (``repro.launch.steps.build_cell(..., mesh=mesh,
smoke=True)``) as its dry run does, then writes
``benchmarks.hlo_analysis.analyze_hlo_text`` of the compiled HLO, by
cell, to ``OUT.json``.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv) -> int:
    import jax

    sys.path[:0] = [HERE, os.path.dirname(HERE)]
    from benchmarks.hlo_analysis import analyze_hlo_text
    from repro.configs import registry
    from repro.launch import steps
    from torch_mesh_oracle import mesh_of
    from torch_op_analysis_worker import CELLS

    for m in registry._MODULES:
        __import__(f"repro.configs.{m}")
    mesh = mesh_of((2, 2))
    out = {}
    for arch, shape in CELLS:
        with mesh:
            cell = steps.build_cell(arch, shape, mesh=mesh, smoke=True)
            compiled = jax.jit(cell.fn, donate_argnums=cell.donate).lower(
                *cell.args).compile()
        out[f"{arch}:{shape}"] = analyze_hlo_text(compiled.as_text())
    with open(argv[1], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.exit(main(sys.argv))

"""The port stands alone and runs on the GPU unless told otherwise.

  * An AST scan: no module under ``src/repro_torch`` and not
    ``chip_smoke.py`` imports ``jax`` or ``repro`` (only the tests import
    both packages).
  * Entry points called without ``device`` on a machine without CUDA
    raise instead of running on the CPU (CUDA is hidden from torch here,
    so the test runs on any machine).
  * Kernel wrappers take the plain version only for CPU tensors, and
    importing the kernels package builds and loads nothing.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import ClusterEngine, make_weights, solver_torch
from repro_torch.data import planted_coclusters
from repro_torch.kernels import codebook_lookup, fused_topk, platform
from repro_torch.models import lightgcn as L
from repro_torch.serve import CompressedArtifact, RecsysSession

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_neither_jax_nor_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [f"{p.relative_to(REPO)}:{line}: {name}"
                 for p in files for line, name in _imports(p)
                 if name.split(".")[0] in FORBIDDEN]
    assert not offenders, "\n".join(offenders)


def test_port_mirrors_reference_subpackages():
    for sub in ("core", "data", "embedding", "kernels", "models", "serve",
                "obs", "launch", "training"):
        assert (PORT / sub / "__init__.py").exists(), sub
        assert (REPO / "src" / "repro" / sub).is_dir(), sub


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small():
    g, _, _ = planted_coclusters(80, 60, 4, 4, seed=0)
    sk = ClusterEngine(device="cpu").build(g, d=8, ratio=0.3)
    cfg = L.from_sketch(g, sk, dim=8, n_layers=1)
    art = CompressedArtifact.from_parts(
        L.init_params(0, cfg), {"edge_u": g.edge_u, "edge_v": g.edge_v,
                                "edge_norm": L.edge_norms(g)}, sk, cfg)
    return g, sk, art


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, small):
    g, sk, art = small
    wu, wv = make_weights(g, "hws")
    calls = [
        lambda: ClusterEngine(),
        lambda: solver_torch.lp_solve(g, wu, wv, 1.0),
        lambda: solver_torch.lp_solve_grid(g, wu, wv, [1.0]),
        lambda: L.make_statics(g, sk),
        lambda: art.statics(),
        lambda: art.session(),
        lambda: RecsysSession(art.params, {}, art.mcfg()),
        lambda: RecsysSession.from_artifact(art),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    # an explicit CPU request still works
    _, ids = art.session(k=3, device="cpu")(np.arange(4))
    assert ids.shape == (4, 3)


def test_launcher_raises_without_cuda(no_cuda):
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--dataset", "synth_xs", "--n-requests", "1"])


def test_wrappers_take_the_plain_version_only_for_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"kernel {name} loaded for a CPU tensor")

    monkeypatch.setattr(platform, "load", refuse)
    before = (codebook_lookup.launches, fused_topk.launches)
    z = torch.randn(5, 4)
    codebook_lookup(z, torch.tensor([[0, 1], [2, 2]], dtype=torch.int32),
                    binary=True)
    fused_topk(torch.randn(2, 4), z, 3)
    assert (codebook_lookup.launches, fused_topk.launches) == before
    # a tensor on another device never falls back to the plain version
    with pytest.raises(ValueError):
        codebook_lookup(z.to("meta"), torch.zeros(1, 1, dtype=torch.int32))


def test_importing_the_port_builds_nothing():
    assert repro_torch.__doc__
    assert platform._LIBS == {}
    assert platform.BUILD_DIR.relative_to(REPO).parts[0] == "build"
    assert sorted(p.stem for p in platform.CSRC.glob("*.cu")) == \
        sorted(platform.KERNELS)

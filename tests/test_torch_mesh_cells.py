"""The recsys, cf and GNN cells over a (data, model) mesh
(``build_cell(mesh=...)``, the layouts of ``distributed/sharding.py``,
the row-sharded lookup and the collectives of ``distributed/
parallel.py``, ``launch.steps.rank_bytes``) against the JAX package, on
the CPU.

* In this process: the params' and statics' specs of every recsys, cf
  and GNN full config (``steps.cell_layouts``) on ``AbstractMesh``
  (16, 16), (2, 16, 16), (2, 2) and (1, 4) equal the reference's
  ``_recsys_param_axes`` / ``_gnn_param_axes`` / the cf cell's axes ->
  ``logical_to_spec`` -> ``_fit_spec``; ``rank_bytes`` equals hand sums
  of the published configs; on a world of 1 (gloo), every recsys, GNN
  and cf smoke cell under ``make_host_mesh("cpu")`` is bitwise its
  one-card twin on the twin's args: outputs, loss, gradients, params
  after one step.
* The oracle (``tests/torch_mesh_oracle.py ... cells``, one subprocess a
  mesh: ``jax.sharding.Mesh`` with Auto axes on 4 host devices) and 4
  gloo ranks (``tests/torch_mesh_cells_worker.py``), started together
  once for the module on the same inputs (the reference's smoke args,
  the batch's ids spread over their ranges), on (2, 2) and (1, 4):
    - every field of the DLRM smoke config (compressed and plain)
      through the row-sharded lookup: its rows and its table's gradient
      bitwise the one-card lookup's;
    - the cells of ``oracle.CELLS``: a serve cell's output within rtol
      1e-4 / atol 1e-5, a train cell's loss within rtol 1e-4 (and the
      step's loss the same) and its gradients within rtol 1e-4 / atol
      1e-6 of the oracle's (the LM mesh's tolerances: the data-axis sums
      add in another order), and its params after one step within rtol
      1e-4 / atol 1e-6 of the reference's AdamW on the gathered
      gradients.
"""
import dataclasses
import functools
import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import lightgcn as ref_lg  # noqa: E402
from repro.models import recsys as ref_rs  # noqa: E402
from repro.models import schnet as ref_schnet  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.distributed import world  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, make_host_mesh  # noqa: E402
from repro_torch.models import recsys as rs  # noqa: E402

import torch_mesh_cells_worker as worker  # noqa: E402
import torch_mesh_oracle as oracle  # noqa: E402

for _m in ref_registry._MODULES:
    importlib.import_module(f"repro.configs.{_m}")

REPO = Path(__file__).resolve().parents[1]
N_RANKS = 4
MESHES = ("2x2", "1x4")
SPEC_MESHES = ((16, 16), (2, 16, 16), (2, 2), (1, 4))
FAMILIES = ("recsys", "gnn", "cf")
CELLS = [(a, s.name) for a in registry.list_archs()
         if registry.get_arch(a).family in FAMILIES
         for s in registry.get_arch(a).shapes]
# one shape an arch for the specs (a recsys or cf cell's layouts do not
# depend on its shape); SchNet's with and without dense node features
SPEC_CELLS = ([(a, registry.get_arch(a).shapes[0].name)
               for a in registry.list_archs()
               if registry.get_arch(a).family in ("recsys", "cf")]
              + [("schnet", "ogb_products"), ("schnet", "molecule")])
assert worker.CELLS == oracle.CELLS


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _names(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


# ---------------------------------------------------------------------------
# specs (no ranks)
# ---------------------------------------------------------------------------
def _ref_layouts(arch, shape):
    """{"params"|"statics": {path: (shape, logical axes)}} of the
    reference's full-width cell, by its own axis rules."""
    spec = ref_registry.get_arch(arch)
    cfg = spec.full_config()
    key = jax.random.PRNGKey(0)
    if spec.family == "recsys":
        init = {"DLRMConfig": ref_rs.dlrm_init,
                "WideDeepConfig": ref_rs.widedeep_init}.get(
            type(cfg).__name__, ref_rs.seqrec_init)
        shapes = jax.eval_shape(functools.partial(init, cfg=cfg), key)
        axes = ref_steps._recsys_param_axes(shapes)
        statics = {k: (v.shape, ("vocab", None)) for k, v in
                   ref_steps._recsys_statics(cfg, None, False).items()}
    elif spec.family == "gnn":
        d_feat = spec.shape(shape).dims.get("d_feat", 0)
        cfg = dataclasses.replace(cfg, d_feat=d_feat)
        shapes = jax.eval_shape(functools.partial(ref_schnet.init_params,
                                                  cfg=cfg), key)
        axes = ref_steps._gnn_param_axes(shapes)
        statics = {}
    else:
        shapes = jax.eval_shape(functools.partial(ref_lg.init_params,
                                                  cfg=cfg), key)
        # the reference's _cf_cell (repro/launch/steps.py:592-605)
        axes = jax.tree.map(lambda x: ("vocab",) + (None,) * (x.ndim - 1),
                            shapes)
        e = max(4 * (cfg.n_users + cfg.n_items), 1024)
        statics = {k: ((e,), ("batch",))
                   for k in ("edge_u", "edge_v", "edge_norm")}
        if cfg.k_users is not None:
            statics["sketch_u"] = ((cfg.n_users, cfg.n_hot_users),
                                   ("vocab", None))
            statics["sketch_v"] = ((cfg.n_items, 1), ("vocab", None))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    flat_axes = treedef.flatten_up_to(axes)
    params = {_path(p): (tuple(x.shape), a) for (p, x), a in
              zip(flat, flat_axes)}
    return {"params": params, "statics": statics}


def _ref_spec(mesh_shape, axes, shape):
    mesh = jax.sharding.AbstractMesh(mesh_shape, _names(mesh_shape))
    spec = ref_steps._fit_spec(mesh, ref_sharding.logical_to_spec(mesh, axes),
                               shape)
    return tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))


@pytest.mark.parametrize("mesh", SPEC_MESHES)
@pytest.mark.parametrize("arch,shape", SPEC_CELLS)
def test_param_and_statics_specs_equal_the_reference(arch, shape, mesh):
    got = steps.cell_layouts(arch, shape, AbstractMesh(mesh, _names(mesh)))
    want = _ref_layouts(arch, shape)
    params = rs.flat_params(got["params"])
    meta = rs.flat_params(got["meta_params"])
    assert set(params) == set(want["params"])
    for k, (shp, axes) in want["params"].items():
        assert tuple(meta[k].shape) == shp, k
        assert params[k].spec == _ref_spec(mesh, axes, shp), k
    statics = got.get("statics", {})
    assert set(statics) == set(want["statics"])
    for k, (shp, axes) in want["statics"].items():
        assert statics[k].spec == _ref_spec(mesh, axes, shp), k


@pytest.mark.parametrize("arch,shape,mesh", [
    ("dlrm-mlperf", "serve_p99", (1, 1)),
    ("dlrm-mlperf", "serve_p99", (1, 4)),
    ("dlrm-mlperf", "train_batch", (1, 4)),
    ("dlrm-mlperf", "train_batch", (1, 8)),
    ("dlrm-mlperf-baco", "train_batch", (2, 2)),
    ("lightgcn-baco", "bpr_train", (2, 2)),
    ("schnet", "ogb_products", (16, 16))])
def test_rank_bytes_equal_hand_sums(arch, shape, mesh):
    """Tables split over all the ranks, the rest whole on each; a train
    cell adds gradients and two f32 moments of the same size. dlrm-mlperf
    is 187,771,136 padded rows x 128 x 4 B = 96.14 GB of tables: 24.04 GB
    a rank on 4 to serve, 96.18 GB a rank on 4 to train (past 80 GB: it
    needs 8, 48.1 GB a rank); dlrm-mlperf-baco trains in 24.12 GB a rank
    on 4."""
    cfg = registry.get_arch(arch).full_config()
    n = int(np.prod(mesh))
    got = steps.rank_bytes(arch, shape, AbstractMesh(mesh, ("data",
                                                            "model")))
    train = shape != "serve_p99"
    if arch.startswith("dlrm"):
        table = sum(rs.pad_rows(cfg.table_rows(f)) for f in
                    range(cfg.n_sparse)) * cfg.embed_dim * 4
        dims = ((cfg.n_dense,) + cfg.bot_mlp,
                (cfg.bot_mlp[-1] + cfg.n_sparse * (cfg.n_sparse + 1) // 2,)
                + cfg.top_mlp)
        dense = sum((i + 1) * o for d in dims
                    for i, o in zip(d[:-1], d[1:])) * 4
        params = table // n + dense
    elif arch == "lightgcn-baco":      # odd rows: the tables stay whole
        params = (cfg.n_users + cfg.n_items) * cfg.dim * 4
    else:
        d, r, f = cfg.d_hidden, cfg.n_rbf, 100          # ogb's d_feat
        lin = lambda i, o: (i + 1) * o                  # noqa: E731
        params = 4 * (cfg.max_z * d + lin(d, d // 2) + lin(d // 2, 1)
                      + lin(f, d) + cfg.n_interactions
                      * (lin(r, d) + 4 * lin(d, d)))
    assert got["params"] == params
    assert got["total"] == params * (4 if train else 1)
    if arch == "dlrm-mlperf":
        assert table == 187_771_136 * 128 * 4
        gb = got["total"] / 1e9
        assert {(1, 1): 96.14 <= gb < 96.15, (1, 4): 24.04 <= gb < 24.05
                if not train else 96.17 <= gb < 96.18,
                (1, 8): 48.10 <= gb < 48.11}[mesh]
    if arch == "dlrm-mlperf-baco":
        assert 24.12 <= got["total"] / 1e9 < 24.13


# ---------------------------------------------------------------------------
# a world of 1: bitwise the one-card cells
# ---------------------------------------------------------------------------
def _clone(a):
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    if isinstance(a, list):
        return [_clone(v) for v in a]
    return a.clone() if torch.is_tensor(a) else a


def _value_and_grad(cell):
    args = cell.args
    if len(args) == 3:                       # SchNet: (params, opt, batch)
        return cell.fn.value_and_grad(args[0], args[2])
    return cell.fn.value_and_grad(args[0], args[2], args[3])


@pytest.fixture(scope="module")
def host_mesh():
    with world("cpu"):
        yield make_host_mesh(device="cpu")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_world_of_one_is_bitwise_the_one_card_cell(host_mesh, arch, shape):
    one = steps.build_cell(arch, shape, smoke=True, device="cpu")
    args = tuple(map(_clone, one.args))
    cell = steps.build_cell(arch, shape, mesh=host_mesh, smoke=True,
                            device="cpu", args=args)
    flat = rs.flat_params(args[0])
    assert all(v is flat[k] for k, v in rs.flat_params(cell.args[0]).items())
    if one.kind != "train":
        assert torch.equal(cell.fn(*cell.args), one.fn(*one.args))
        return
    loss, grads = _value_and_grad(cell)
    want_loss, want_grads = _value_and_grad(one)
    assert torch.equal(loss, want_loss)
    for k, g in want_grads.items():
        assert torch.equal(grads[k], g), k
    got, want = cell.fn(*cell.args), one.fn(*one.args)
    assert torch.equal(got[2], want[2])
    want_p = rs.flat_params(want[0])
    for k, v in rs.flat_params(cell.gather("params", got[0])).items():
        assert torch.equal(v, want_p[k]), k


# ---------------------------------------------------------------------------
# 4 gloo ranks and the oracle
# ---------------------------------------------------------------------------
def write_inputs(path) -> None:
    """Each cell's params, statics and batch, the reference's smoke args
    with the batch spread (``oracle.cell_inputs``), as one ``.npz``."""
    out = {}
    for arch, shape in oracle.CELLS:
        ref, args = oracle.cell_inputs(arch, shape)
        parts = {"params": args[0], "batch": args[-1]}
        if len(args) == 4 or ref.kind != "train":
            parts["statics"] = args[-2]
        for name, tree in parts.items():
            flat, _ = jax.tree_util.tree_flatten_with_path(tree)
            for p, x in flat:
                out[f"{arch}:{shape}/{name}/{_path(p)}"] = np.asarray(x)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results (rank 0's), the oracle's arrays and the
    inputs, all made once."""
    tmp = tmp_path_factory.mktemp("mesh_cells")
    inputs = tmp / "inputs.npz"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_mesh_oracle.py"),
         str(tmp / f"oracle_{m}.npz"), m, "cells"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for m in MESHES]
    errs = []
    try:
        write_inputs(inputs)
        procs += [subprocess.Popen(
            [sys.executable,
             str(REPO / "tests" / "torch_mesh_cells_worker.py"), str(r),
             str(N_RANKS), str(tmp / "store"), str(tmp), str(inputs)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(N_RANKS)]
        deadline = time.monotonic() + 300     # one limit for all of them
        for p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
            errs.append((p.returncode, err[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(rc == 0 for rc, _ in errs), errs
    with open(tmp / "rank0.pkl", "rb") as f:
        got = pickle.load(f)
    want = {}
    for m in MESHES:
        z = np.load(tmp / f"oracle_{m}.npz")
        want.update({k: z[k] for k in z.files})
    return got, want, worker.load_inputs(str(inputs))


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("mesh", MESHES)
def test_row_sharded_lookups_are_bitwise_the_one_card_lookup(ranks, mesh):
    got, _, _ = ranks
    res = got[mesh]["lookups"]
    assert {r["compressed"] for r in res.values()} == {True, False}
    assert all(r["split"] for r in res.values())
    for f, r in res.items():
        assert r["rows"] and r["grad"], (f, r)


def _ref_adamw(params: dict, grads: dict) -> dict:
    """The reference's AdamW step (lr 1e-3, the cells' optimizer) of flat
    params on flat gradients, flat."""
    from repro.training import optimizer as ref_opt
    opt = ref_opt.adamw(lr=1e-3)
    p = {k: jnp.asarray(np.asarray(v, np.float32)) for k, v in params.items()}
    new, _ = opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                        opt.init(p), p)
    return {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch,shape", oracle.CELLS)
def test_mesh_cells_equal_the_reference_mesh(ranks, arch, shape, mesh):
    got, want, inputs = ranks
    g = got[mesh][f"{arch}:{shape}"]
    pre = f"{mesh}/{arch}:{shape}"
    # the reference gives these families no data-axis layout: their
    # notes claim none
    assert "data=" in g["notes"] and "ZeRO" not in g["notes"]
    if "out" in g:
        _close(g["out"], want[f"{pre}/out"], 1e-4, 1e-5, "out")
        return
    _close(g["loss"], want[f"{pre}/loss"], 1e-4, 0, "loss")
    _close(g["step_loss"], want[f"{pre}/loss"], 1e-4, 0, "step loss")
    assert set(g["grads"]) == {k[len(pre) + 7:] for k in want
                               if k.startswith(f"{pre}/grads/")}
    for k, v in g["grads"].items():
        _close(v, want[f"{pre}/grads/{k}"], 1e-4, 1e-6, k)
    new = _ref_adamw(rs.flat_params(inputs[f"{arch}:{shape}"]["params"]),
                     g["grads"])
    for k, v in g["params"].items():
        _close(v, new[k], 1e-4, 1e-6, k)

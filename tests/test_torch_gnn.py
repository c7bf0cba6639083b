"""The GNN family of the port (``data/neighbor_sampler.py``,
``models/schnet.py``, ``configs/schnet.py``, the GNN half of
``launch/steps.py``) against the JAX package, on the CPU at small sizes,
with the reference's params carried over (``schnet.params_from_numpy``).

  * The sampler: ``random_regular_csr`` and ``sample_subgraph`` return
    bitwise the reference's for the same seeds.
  * The model's pieces: the RBF centres equal ``jnp.linspace`` bitwise;
    ``_ssp``, ``_rbf_expand`` and ``_cosine_cutoff`` equal the
    reference's within rtol 1e-5 (f32); a bf16 input to ``_ssp`` promotes
    to f32 in both, within one bf16 ulp.
  * ``energy``, ``train_loss`` and ``node_train_loss``, and the gradient
    of every param, against the reference and ``jax.grad`` at the smoke
    config and a d_feat config: values within rtol 1e-5 / atol 1e-6,
    gradients within rtol 1e-4 / atol 1e-6 (f32 GEMMs and the loss's
    reductions sum in another order; the segment sums add in the
    reference's order). The port runs the "cuda" lookup backend (on the
    CPU its plain versions) and the CSR plans of ``edge_plan``.
  * The reference's SchNet invariances (``tests/test_models.py``: edge
    permutation, the cutoff) as cases on the port.
  * ``build_cell("schnet", shape, smoke=True)`` for the four shapes: the
    draws bitwise the reference's ``_materialize``; one step's loss within
    rtol 1e-5, and the params after one AdamW step within rtol 1e-4 /
    atol 4e-6 of the reference's AdamW on the port's gradients (Adam's
    first step turns a gradient that is rounding in one package and 0 in
    the other into ~lr). Full-width molecule and full_graph_sm cells on
    the CPU: padded shapes, masks, pad edges past the cutoff, one step.
  * ``launch.train --arch schnet`` in a subprocess.
"""
import dataclasses
import functools
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as ref_registry  # noqa: E402
from repro.data import neighbor_sampler as ref_sampler  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import schnet as RS  # noqa: E402
from repro.training import optimizer as ref_opt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import neighbor_sampler  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import schnet as S  # noqa: E402

for _m in ref_registry._MODULES:
    importlib.import_module(f"repro.configs.{_m}")

SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
RTOL, ATOL = 1e-5, 1e-6            # values
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # gradients


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _ref_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path(p): np.asarray(x, dtype=np.float32) for p, x in flat}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, n=40, e=120, n_graphs=3, seed=0) -> dict:
    """A numpy batch: edges uniform over the nodes, distances in
    [0, 1.2 x cutoff), atoms in [0, max_z) in ``n_graphs`` contiguous
    graphs, or dense features; targets standard normal."""
    rng = np.random.default_rng(seed)
    b = {"edge_src": rng.integers(0, n, e).astype(np.int32),
         "edge_dst": rng.integers(0, n, e).astype(np.int32),
         "edge_dist": rng.uniform(0, 1.2 * cfg.cutoff, e).astype(np.float32),
         "targets": rng.standard_normal(n_graphs).astype(np.float32),
         "node_targets": rng.standard_normal(n).astype(np.float32),
         "node_mask": (rng.random(n) < 0.7).astype(np.float32),
         "graph_id": np.sort(rng.integers(0, n_graphs, n)).astype(np.int32)}
    if cfg.d_feat:
        b["feat"] = rng.standard_normal((n, cfg.d_feat)).astype(np.float32)
    else:
        b["z"] = rng.integers(0, cfg.max_z, n).astype(np.int32)
    return b


def _torch_batch(b: dict) -> dict:
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _configs():
    smoke = registry.get_arch("schnet").smoke_config()
    return {"smoke": smoke,
            "d_feat": dataclasses.replace(smoke, d_feat=12)}


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    cfg = _configs()[name]
    return _to_np(RS.init_params(jax.random.PRNGKey(0), _ref_cfg(cfg)))


def _ref_cfg(cfg):
    """The reference's config of the port's, its lookup on "gather"."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return RS.SchNetConfig(**{**fields, "lookup_backend": "gather"})


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,deg,fanout", [(500, 5, (5, 3)),
                                          (2000, 12, (15, 10))])
def test_neighbor_sampler_equals_the_reference_bitwise(n, deg, fanout):
    got = neighbor_sampler.random_regular_csr(n, deg, seed=3)
    want = ref_sampler.random_regular_csr(n, deg, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    seeds = np.random.default_rng(1).choice(n, 64, replace=False)
    got = neighbor_sampler.sample_subgraph(*want, seeds, fanout, seed=5)
    want = ref_sampler.sample_subgraph(*want, seeds, fanout, seed=5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert len(got[1]) == 64 * fanout[0] * (1 + (fanout[1]
                                                 if len(fanout) > 1 else 0))


# ---------------------------------------------------------------------------
# the model's pieces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_rbf,cutoff", [(8, 5.0), (300, 10.0), (7, 3.3)])
def test_rbf_centers_equal_jnp_linspace(n_rbf, cutoff):
    cfg = S.SchNetConfig(n_rbf=n_rbf, cutoff=cutoff)
    got = S.rbf_centers(cfg).numpy()
    want = np.asarray(jnp.linspace(0.0, cutoff, n_rbf))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    dist = np.random.default_rng(0).uniform(0, 12, 257).astype(np.float32)
    np.testing.assert_allclose(
        S._rbf_expand(torch.as_tensor(dist), cfg).numpy(),
        np.asarray(RS._rbf_expand(jnp.asarray(dist), _ref_cfg(cfg))),
        rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(
        S._cosine_cutoff(torch.as_tensor(dist), cutoff).numpy(),
        np.asarray(RS._cosine_cutoff(jnp.asarray(dist), cutoff)),
        rtol=RTOL, atol=1e-7)


def test_ssp_equals_the_reference_and_promotes_16_bit():
    x = np.linspace(-30, 30, 1001).astype(np.float32)
    got = S._ssp(torch.as_tensor(x)).numpy()
    want = np.asarray(RS._ssp(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    # np.log(2.0) is a strongly typed scalar: a bf16 input promotes to f32
    # (the softplus itself is bf16 in both, rounded in other places:
    # within one bf16 ulp, 2^-7 relative)
    want16 = RS._ssp(jnp.asarray(x, jnp.bfloat16))
    got16 = S._ssp(torch.as_tensor(x).bfloat16())
    assert want16.dtype == jnp.float32 and got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), np.asarray(want16),
                               rtol=2.0 ** -7, atol=2.0 ** -7)
    # the gradient at 0 is 1/2, as jax.grad of softplus gives
    t = torch.zeros(1, requires_grad=True)
    S._ssp(t).sum().backward()
    assert float(t.grad) == float(jax.grad(lambda v: RS._ssp(v))(0.0)) == 0.5


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------
def _port_fn(fn, cfg, n_graphs):
    if fn == "energy":
        return lambda p, b: S.energy(p, b, cfg, n_graphs=n_graphs).sum()
    return lambda p, b: getattr(S, fn)(p, b, cfg)


def _ref_fn(fn, cfg, n_graphs):
    rc = _ref_cfg(cfg)
    if fn == "energy":
        return lambda p, b: RS.energy(p, b, rc, n_graphs=n_graphs).sum()
    return lambda p, b: getattr(RS, fn)(p, b, rc)


@pytest.mark.parametrize("fn", ["energy", "train_loss", "node_train_loss"])
@pytest.mark.parametrize("name", ["smoke", "d_feat"])
def test_schnet_and_its_gradients_equal_the_reference(name, fn):
    cfg = dataclasses.replace(_configs()[name], lookup_backend="cuda")
    b = _batch(cfg)
    if fn == "node_train_loss" and name == "smoke":
        del b["node_mask"]                       # the mean over all nodes
    ref_params = _ref_params(name)
    want, ref_grads = jax.value_and_grad(_ref_fn(fn, cfg, 3))(
        jax.tree.map(jnp.asarray, ref_params),
        {k: jnp.asarray(v) for k, v in b.items()})
    params = S.params_from_numpy(ref_params, device="cpu")
    flat = S.flat_params(params)
    for p in flat.values():
        p.requires_grad_(True)
    got = _port_fn(fn, cfg, 3)(params, _torch_batch(b))
    grads = torch.autograd.grad(got, list(flat.values()), allow_unused=True)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL,
                               atol=ATOL)
    ref_g = _ref_flat(ref_grads)
    assert set(ref_g) == set(flat)
    for k, g in zip(flat, grads):
        g = np.zeros_like(ref_g[k]) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref_g[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


def test_edge_plan_is_built_once_per_batch_and_serves_every_block():
    cfg = _configs()["smoke"]
    b = _torch_batch(_batch(cfg))
    params = S.params_from_numpy(_ref_params("smoke"), device="cpu")
    plan = S.edge_plan(b["edge_src"], b["edge_dst"], b["z"].shape[0])
    calls = []
    orig = S.edge_plan
    try:
        S.edge_plan = lambda *a: calls.append(a) or orig(*a)
        with_plan = S.energy(params, b, cfg, n_graphs=3, plan=plan)
        assert not calls
        without = S.energy(params, b, cfg, n_graphs=3)
        assert len(calls) == 1
    finally:
        S.edge_plan = orig
    assert torch.equal(with_plan, without)
    assert torch.equal(plan.dst_ptr[-1], torch.tensor(b["edge_dst"].numel()))


def test_schnet_edge_permutation_invariant():
    cfg = S.SchNetConfig(n_interactions=2, d_hidden=8, n_rbf=4)
    params = S.params_from_numpy(_to_np(RS.init_params(
        jax.random.PRNGKey(0), _ref_cfg(cfg))), device="cpu")
    rng = np.random.default_rng(0)
    n, e = 10, 24
    batch = {"z": torch.as_tensor(rng.integers(1, 10, n), dtype=torch.int32),
             "edge_src": torch.as_tensor(rng.integers(0, n, e),
                                         dtype=torch.int32),
             "edge_dst": torch.as_tensor(rng.integers(0, n, e),
                                         dtype=torch.int32),
             "edge_dist": torch.as_tensor(rng.random(e) * 4,
                                          dtype=torch.float32),
             "graph_id": torch.zeros(n, dtype=torch.int32)}
    e1 = S.energy(params, batch, cfg, n_graphs=1)
    perm = torch.as_tensor(rng.permutation(e))
    batch2 = {**batch, "edge_src": batch["edge_src"][perm],
              "edge_dst": batch["edge_dst"][perm],
              "edge_dist": batch["edge_dist"][perm]}
    e2 = S.energy(params, batch2, cfg, n_graphs=1)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-5)


def test_schnet_cutoff_zeroes_long_edges():
    cfg = S.SchNetConfig(n_interactions=1, d_hidden=8, n_rbf=4, cutoff=2.0)
    params = S.params_from_numpy(_to_np(RS.init_params(
        jax.random.PRNGKey(0), _ref_cfg(cfg))), device="cpu")
    i32, f32 = torch.int32, torch.float32
    base = {"z": torch.tensor([1, 2, 3], dtype=i32),
            "edge_src": torch.tensor([0, 1], dtype=i32),
            "edge_dst": torch.tensor([1, 2], dtype=i32),
            "graph_id": torch.zeros(3, dtype=i32)}
    e_short = S.energy(params, {**base, "edge_dist":
                                torch.tensor([1.0, 1.0], dtype=f32)},
                       cfg, n_graphs=1)
    # edges beyond cutoff contribute nothing == no edges at all
    e_long = S.energy(params, {**base, "edge_dist":
                               torch.tensor([5.0, 9.0], dtype=f32)},
                      cfg, n_graphs=1)
    e_none = S.energy(params, {**base,
                               "edge_src": torch.tensor([0, 0], dtype=i32),
                               "edge_dst": torch.tensor([0, 0], dtype=i32),
                               "edge_dist": torch.tensor([9.0, 9.0],
                                                         dtype=f32)},
                      cfg, n_graphs=1)
    np.testing.assert_allclose(e_long.numpy(), e_none.numpy(), rtol=1e-5)
    assert not np.allclose(e_short.numpy(), e_long.numpy())


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_cell(shape):
    return ref_steps.build_cell("schnet", shape, smoke=True)


@pytest.mark.parametrize("shape", SHAPES)
def test_smoke_cell_draws_and_step_equal_the_reference(shape):
    ref = _ref_cell(shape)
    cell = steps.build_cell("schnet", shape, smoke=True, device="cpu")
    assert cell.kind == ref.kind == "train" and cell.reduced == ()
    want_b = {k: np.asarray(v) for k, v in ref.args[2].items()}
    got_b = cell.args[2]
    assert sorted(got_b) == sorted(want_b)
    for k, v in want_b.items():
        g = got_b[k].numpy()
        assert g.dtype == v.dtype and np.array_equal(g, v), k
    # one step on the reference's params: loss, then AdamW on the port's
    # gradients in both packages
    ref_params = _to_np(ref.args[0])
    params = S.params_from_numpy(ref_params, device="cpu")
    flat = S.flat_params(params)
    opt_state = cell.args[1]
    for k, v in flat.items():
        assert opt_state["m"][k].shape == v.shape
    grads_seen = {}
    orig = torch.autograd.grad

    def spy(loss, leaves, **kw):
        out = orig(loss, leaves, **kw)
        grads_seen.update({id(t): g for t, g in zip(leaves, out)})
        return out
    torch.autograd.grad = spy
    try:
        _, _, loss = cell.fn(params, opt_state, got_b)
    finally:
        torch.autograd.grad = orig
    cfg = ref_registry.get_arch("schnet").smoke_config()
    d_feat = 0 if shape == "molecule" else 16
    rcfg = dataclasses.replace(cfg, d_feat=d_feat)
    ref_loss = (RS.train_loss if shape == "molecule"
                else RS.node_train_loss)
    want = ref_loss(jax.tree.map(jnp.asarray, ref_params),
                    {k: jnp.asarray(v) for k, v in want_b.items()}, rcfg)
    np.testing.assert_allclose(float(loss), float(want), rtol=RTOL,
                               atol=ATOL)
    # the step asks no gradient of a param the loss does not read (the
    # atom embedding under d_feat): zero, as under jax.grad
    port_g = {k: (grads_seen[id(v)].numpy() if id(v) in grads_seen
                  else np.zeros(v.shape, np.float32))
              for k, v in flat.items()}
    # the reference's AdamW on the port's gradients
    tree_g = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(ref.args[0]),
        [jnp.asarray(port_g[_path(p)]) for p, _ in
         jax.tree_util.tree_flatten_with_path(ref.args[0])[0]])
    opt = ref_opt.adamw(lr=1e-3)
    new_ref, _ = opt.update(tree_g, opt.init(ref.args[0]), ref.args[0])
    new_ref = _ref_flat(new_ref)
    for k, v in flat.items():
        np.testing.assert_allclose(v.detach().numpy(), new_ref[k],
                                   rtol=1e-4, atol=4e-6, err_msg=k)


def test_train_step_zeroes_only_the_named_unread_params():
    """The shared AdamW step gives a zero gradient only to the params it
    is told the loss does not read (SchNet's atom embedding under
    d_feat); any other unread param raises, as before."""
    from repro_torch.training import optimizer as opt_lib

    def run(unread):
        params = {"a": torch.ones(3), "b": torch.ones(3)}
        opt = opt_lib.adamw(lr=1e-2)
        state = opt.init(S.flat_params(params))
        step = steps._adamw_step(lambda p, s, b: (p["a"] ** 2).sum(), opt,
                                 unread=unread)
        step(params, state, None, None)
        return params

    with pytest.raises(RuntimeError):
        run(())
    params = run(("b",))
    assert torch.equal(params["b"], torch.ones(3))
    assert not torch.equal(params["a"], torch.ones(3))


def test_full_width_cells_on_the_cpu_pad_and_mask():
    """The two small full-width cells on the CPU: the published widths,
    the reference's pod padding (pad nodes masked out, pad edges past
    the cutoff), atoms of QM9's elements in 128 graphs of 30, and one
    finite step."""
    mol = steps.build_cell("schnet", "molecule", device="cpu")
    b = mol.args[2]
    assert b["z"].shape == (3840,) and b["edge_src"].shape == (8192,)
    assert set(b["z"].unique().tolist()) <= set(steps.GNN_ELEMENTS)
    assert torch.equal(b["graph_id"], torch.arange(3840,
                                                   dtype=torch.int32) // 30)
    assert torch.equal(b["edge_src"] // 30, b["edge_dst"] // 30)
    assert mol.args[0]["blocks"][0]["filt1"]["w"].shape == (300, 64)
    fg = steps.build_cell("schnet", "full_graph_sm", device="cpu")
    b = fg.args[2]
    assert b["feat"].shape == (2816, 1433) and b["edge_dist"].shape == (10752,)
    assert float(b["node_mask"].sum()) == 2708
    assert bool((b["node_mask"][2708:] == 0).all())
    assert bool((b["edge_dist"][10556:] >= 10.0).all())
    assert bool((b["edge_dist"][:10556] < 12.0).all())
    assert 0.1 < float((b["edge_dist"][:10556] >= 10.0).float().mean()) < 0.25
    for cell in (mol, fg):
        assert np.isfinite(float(cell.fn(*cell.args)[2]))
    assert steps.GNN_ONE_CARD[("schnet", "ogb_products")] == {
        "n_edges": 61_859_140 // 8}


def test_minibatch_lg_batch_comes_from_the_sampler(monkeypatch):
    """The minibatch_lg cell's edges are the sampler's over the cell's
    graph (shrunk here to 3,000 nodes at mean degree 8), padded to the
    static node count; its mask marks the seeds."""
    monkeypatch.setattr(steps, "GNN_SAMPLED_GRAPH",
                        {"n_nodes": 3000, "avg_deg": 8})
    dims = dict(registry.get_arch("schnet").shape("minibatch_lg").dims)
    cfg = registry.get_arch("schnet").full_config()
    b, notes = steps._gnn_batch("minibatch_lg", dims, 169984, 168960, 602,
                                cfg, "cpu")
    indptr, indices = ref_sampler.random_regular_csr(3000, 8, seed=0)
    seeds = np.random.default_rng(0).choice(3000, 1024, replace=False)
    nodes, src, dst = ref_sampler.sample_subgraph(indptr, indices, seeds,
                                                  (15, 10), seed=0)
    assert np.array_equal(b["edge_src"].numpy(), src)
    assert np.array_equal(b["edge_dst"].numpy(), dst)
    assert float(b["node_mask"].sum()) == 1024 and bool(
        (b["node_mask"][:1024] == 1).all())
    assert b["feat"].shape == (169984, 602) and len(nodes) <= 169984
    assert notes and "sampled" in notes[0]


def test_registry_has_schnet_and_its_cuts():
    assert "schnet" in registry.list_archs()
    assert "schnet" not in registry.UNPORTED_ARCHS
    with pytest.raises(TypeError, match="no cuts"):
        steps.build_cell("dlrm-mlperf", "serve_p99", smoke=True,
                         device="cpu", n_edges=3)


def test_train_cli_schnet_runs_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "schnet",
         "--shape", "molecule", "--device", "cpu", "--steps", "2"],
        capture_output=True, text=True, env=env, timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr
    assert "schnet:molecule x2 smoke steps on cpu" in out.stdout

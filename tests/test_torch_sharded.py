"""The port's sharded BACO pipeline (``repro_torch.distributed``, the
"torch_sharded" solver, the ``fused_sharded`` trainer,
``training.compress``) against the JAX package, on the CPU over gloo.

* In this process: the edge partition and shard padding equal the
  reference's arrays and errors; on a world of 1, the sharded solve is
  bitwise ``solver_jax.lp_solve``, the sharded build gives the
  reference's sketch, and ``fused_sharded`` is bitwise ``fused``; the
  engine's auto-selection follows the reference's rule; the compression
  round trips equal the reference's (int8 fed the reference's Bernoulli
  draws) and stay unbiased with torch generators.
* Four spawned ranks (``tests/torch_sharded_worker.py``, started once
  for the module): the sharded labels and sweeps equal the reference's
  in its three pinned cases, the sharded sketch equals the reference's,
  ``fused_sharded`` matches ``fused`` within the reference's mesh-of-4
  tolerances, an indivisible batch raises, and the compressed gradient
  mean follows the reference's formula (int8 exactly; bf16 within the
  rounding bound of two bf16 summation orders).
* Outside a world the sharded calls raise and leave no process group.
* ``torchrun`` with two ranks runs the train CLI with both sharded
  pieces.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from benchmarks.cluster_scale_bench import _shard_balance as jax_shard_balance
from repro.core import ClusterEngine as JaxEngine
from repro.core import solver_jax
from repro.data import planted_coclusters as jax_planted
from repro.distributed.sharding import edge_partition as jax_edge_partition
from repro.distributed.sharding import pad_to_shards as jax_pad_to_shards
from repro.training.compress import compress_decompress as jax_compress

from repro_torch.core import ClusterEngine, get_solver
from repro_torch.core.solver_sharded import lp_solve_sharded
from repro_torch.distributed import (cluster_mesh, data_mesh, edge_partition,
                                     pad_to_shards, use_mesh, world)
from repro_torch.launch.cluster_scale import shard_balance
from repro_torch.training import TrainConfig, Trainer
from repro_torch.training.compress import (compress_decompress,
                                           mean_grads_compressed)

import torch_sharded_worker as worker

REPO = Path(__file__).resolve().parents[1]
N_RANKS = 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    # thousands of tiny ops a step (the CSR gather-sum's plain version);
    # intra-op threads only add barriers, worst beside other test workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    gj, _, _ = jax_planted(300, 240, k_true=12, avg_deg=10, seed=0)
    g, (wu, wv) = worker.planted()
    return gj, g, wu, wv


@pytest.fixture(scope="module")
def ref_sketch(graphs):
    return JaxEngine(solver="jax").build(graphs[0], d=16, ratio=0.3)


@pytest.fixture
def world1():
    with world("cpu") as dev:
        yield dev
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every multi-rank case, run once by 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("ranks")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_sharded_worker.py"),
         str(r), str(N_RANKS), str(tmp / "store"), str(tmp)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(N_RANKS)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err))
    assert all(rc == 0 for rc, _ in errs), errs
    out = []
    for r in range(N_RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the edge partition
# ---------------------------------------------------------------------------
def _node_bounds(g, n_shards, side="user"):
    """Node-aligned edge offsets cutting one side's nodes into n_shards
    runs of near-equal node counts."""
    indptr = (g.user_csr() if side == "user" else g.item_csr())[0]
    n = indptr.size - 1
    return indptr[np.linspace(0, n, n_shards + 1).astype(np.int64)]


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("mode", ["uniform", "bounds"])
@pytest.mark.parametrize("side", ["user", "item"])
def test_edge_partition_equals_the_reference(graphs, n_shards, mode, side):
    _, g, wu, wv = graphs
    if side == "user":
        node, opp, n_side, w = g.edge_u, g.edge_v, g.n_users, wu
    else:
        node, opp = g.edge_v[g.perm_by_item], g.edge_u[g.perm_by_item]
        n_side, w = g.n_items, wv
    kw = {}
    if mode == "bounds":
        kw["bounds"] = _node_bounds(g, n_shards, side)
    got = edge_partition(node, opp, n_side, n_shards, **kw)
    want = jax_edge_partition(node, opp, n_side, n_shards, **kw)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    nps = got[2]
    for fill in (0, -1):
        np.testing.assert_array_equal(
            pad_to_shards(np.asarray(w, np.float32), n_shards, nps, fill),
            jax_pad_to_shards(np.asarray(w, np.float32), n_shards, nps,
                              fill))


@pytest.mark.parametrize("bad", ["size", "cover", "straddle"])
def test_edge_partition_refuses_what_the_reference_refuses(graphs, bad):
    _, g, _, _ = graphs
    indptr = g.user_csr()[0]
    if bad == "size":
        bounds = _node_bounds(g, 3)
    elif bad == "cover":
        bounds = np.array([0, indptr[100], g.n_edges - 1], np.int64)
    else:
        node = int(np.argmax(np.diff(indptr) >= 2))
        bounds = np.array([0, indptr[node] + 1, g.n_edges], np.int64)
    for fn in (edge_partition, jax_edge_partition):
        with pytest.raises(ValueError):
            fn(g.edge_u, g.edge_v, g.n_users, 2, bounds=bounds)


def test_shard_balance_equals_the_reference(graphs):
    gj, g, _, _ = graphs
    assert shard_balance(g) == jax_shard_balance(gj)
    assert shard_balance(g, 3) == jax_shard_balance(gj, 3)


# ---------------------------------------------------------------------------
# a world of 1, in this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("gamma,budget", [(1.0, None), (4.0, 135)])
def test_sharded_world_of_one_is_bitwise_lp_solve(graphs, world1, gamma,
                                                  budget):
    _, g, wu, wv = graphs
    want, it_want = solver_jax.lp_solve(g, wu, wv, gamma, budget, 8)
    stats = {}
    got, it = lp_solve_sharded(g, wu, wv, gamma, budget, 8, device=world1,
                               stats=stats)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert it == int(it_want) == stats["sweeps"]


def test_sharded_engine_build_is_the_reference_sketch(graphs, ref_sketch,
                                                      world1):
    g, ref = graphs[1], ref_sketch
    sk = ClusterEngine(solver="torch_sharded", device="cpu").build(
        g, d=16, ratio=0.3)
    assert sk.meta["solver"] == "torch_sharded"
    assert sk.user_idx.shape == (g.n_users, 2)
    np.testing.assert_array_equal(sk.user_idx, ref.user_idx)
    np.testing.assert_array_equal(sk.item_idx, ref.item_idx)
    assert sk.meta["gamma"] == ref.meta["gamma"]


def test_auto_selection_follows_the_reference_rule(four_ranks):
    assert not dist.is_initialized()
    assert ClusterEngine(device="cpu").resolve().name == "torch"
    with world("cpu"):
        assert ClusterEngine(device="cpu").resolve().name == "torch"
        mesh = cluster_mesh(device="cpu")
        eng = ClusterEngine(device="cpu", mesh=mesh)
        assert eng.resolve().name == "torch_sharded"
        assert ClusterEngine(solver="torch", device="cpu",
                             mesh=mesh).resolve().name == "torch"
        assert eng._kw(get_solver("torch_sharded"))["mesh"] is mesh
        assert "mesh" not in eng._kw(get_solver("torch"))
        with pytest.raises(ValueError, match="world of 2"):
            cluster_mesh(2, device="cpu")
    assert not dist.is_initialized()
    assert [r["auto"] for r in four_ranks] == ["torch_sharded"] * N_RANKS


def test_mesh_makes_a_world_of_one_and_use_mesh_scopes_it():
    """A mesh needs an open world (``world`` makes one of 1 and ends
    it); ``use_mesh`` scopes the mesh that ``current_mesh`` reads."""
    from repro_torch.distributed import batch_axes, current_mesh
    assert not dist.is_initialized()
    for fn in (cluster_mesh, data_mesh):
        with pytest.raises(RuntimeError, match="distributed.world"):
            fn(device="cpu")
    with world("cpu"):
        mesh = data_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
        assert current_mesh() is None
        with use_mesh(mesh):
            assert current_mesh() is mesh and batch_axes(mesh) == ("data",)
        assert current_mesh() is None
        assert batch_axes(cluster_mesh(device="cpu")) == ()
    assert not dist.is_initialized()


def test_sharded_calls_outside_a_world_raise_and_leave_none(graphs):
    """The sharded solve, build and trainer make no process group of
    their own: outside a world they raise, and none is left behind."""
    _, g, wu, wv = graphs
    calls = (
        lambda: lp_solve_sharded(g, wu, wv, 1.0, None, 8, device="cpu"),
        lambda: ClusterEngine(solver="torch_sharded", device="cpu").build(
            g, d=16, ratio=0.3),
        lambda: Trainer(g, None, TrainConfig(backend="fused_sharded",
                                             **worker.TRAIN), device="cpu"))
    for call in calls:
        with pytest.raises(RuntimeError, match="distributed.world"):
            call()
        assert not dist.is_initialized()


def _train(g, sk, backend, **kw):
    # CPU steps run the CSR gather-sum's plain version (~0.2 s a step)
    tr = Trainer(g, sk, TrainConfig(backend=backend, **dict(worker.TRAIN,
                                                            **kw)),
                 device="cpu")
    return tr.run(log_every=0), tr


def test_fused_sharded_world_of_one_is_bitwise_fused(graphs, world1):
    _, g, _, _ = graphs
    sk = ClusterEngine(device="cpu").build(g, d=16, ratio=0.3)
    la, a = _train(g, sk, "fused", steps=8)
    lb, b = _train(g, sk, "fused_sharded", steps=8)
    assert la == lb
    for k, v in a.params.items():
        assert torch.equal(b.params[k], v)
    n = sum(int(v.numel()) for v in a.params.values())
    assert b.backend.allreduce_bytes == 4 * (n + 1)
    assert b.backend.saves


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", worker.SOLVE_CASES)
def test_sharded_four_ranks_give_the_reference_labels(graphs, four_ranks,
                                                      case):
    _, g, wu, wv = graphs
    want, it_want = solver_jax.lp_solve(g, wu, wv, case[0], case[1], 8)
    for r in four_ranks:
        labels, it = r["solve"][case]
        np.testing.assert_array_equal(labels, np.asarray(want))
        assert it == int(it_want)


def test_sharded_four_ranks_build_the_reference_sketch(ref_sketch,
                                                       four_ranks):
    ref = ref_sketch
    for r in four_ranks:
        user_idx, item_idx, gamma = r["sketch"]
        np.testing.assert_array_equal(user_idx, ref.user_idx)
        np.testing.assert_array_equal(item_idx, ref.item_idx)
        assert gamma == ref.meta["gamma"]


def test_fused_sharded_four_ranks_match_fused(four_ranks):
    la, pa = four_ranks[0]["fused"]
    lb, pb = four_ranks[0]["fused_sharded"]
    # the reference's mesh-of-4 tolerances: the all-reduce reassociates
    # f32 sums; Adam's normalization amplifies that on near-zero entries
    np.testing.assert_allclose(np.asarray(la), np.asarray(lb), rtol=1e-5,
                               atol=1e-6)
    for k in pa:
        np.testing.assert_allclose(pa[k], pb[k], atol=1e-3)
    for r in four_ranks[1:]:                  # params stay replicated
        assert r["fused_sharded"][0] == lb
        for k in pb:
            np.testing.assert_array_equal(r["fused_sharded"][1][k], pb[k])
    assert all("not divisible by the 4-device" in r["indivisible"]
               for r in four_ranks)
    assert all("this world has 4" in r["n_devices"] for r in four_ranks)


def test_mean_grads_compressed_four_ranks_follow_the_reference(four_ranks):
    grads = [worker.compress_grads(r) for r in range(N_RANKS)]
    for k in grads[0]:
        # int8: codes at each rank's own scale, an int32 sum, then that
        # rank's scale / n (the reference's sync body, in jnp)
        scales = [jnp.max(jnp.abs(jnp.asarray(g[k]))) / 127.0 + 1e-12
                  for g in grads]
        total = sum(jnp.round(jnp.asarray(g[k]) / s).astype(jnp.int8)
                    .astype(jnp.int32) for g, s in zip(grads, scales))
        for r, s in enumerate(scales):
            want = np.asarray(total.astype(jnp.float32) * s / N_RANKS)
            np.testing.assert_array_equal(four_ranks[r]["mean"]["int8"][k],
                                          want)
        # bf16: a mean in bfloat16. Gloo's ring adds the four bf16 values
        # in its own order, rounding each of its 3 adds to bf16 (at most
        # u = 2^-8, bf16's unit roundoff, of sum|x| each); the formula's
        # f32 sum (at most 3 * 2^-24 of sum|x|) rounds to bf16 once (u);
        # dividing by n = 4 is exact. The two means therefore differ by
        # at most (4 * 2^-8 + 3 * 2^-24) of sum|x| / n. Measured: 193 of
        # 512 and 42 of 128 entries differ, the largest by 0.0076 of
        # sum|x| / n; a mean that leaves one rank out or skips the /n is
        # far outside the bound
        x = np.stack([np.asarray(jnp.asarray(g[k]).astype(jnp.bfloat16)
                                 .astype(jnp.float32)) for g in grads])
        want = np.asarray((jnp.asarray(x).sum(0).astype(jnp.bfloat16)
                           / N_RANKS).astype(jnp.float32))
        bound = np.abs(x).sum(0) / N_RANKS * (4 * 2.0 ** -8 + 3 * 2.0 ** -24)
        for wrong in (x[1:].sum(0) / N_RANKS, x.sum(0)):
            assert np.any(np.abs(wrong - want) > bound)
        for r in range(N_RANKS):
            got = four_ranks[r]["mean"]["bf16"][k]
            assert got.dtype == np.float32
            assert np.all(np.abs(got - want) <= bound)
            np.testing.assert_array_equal(got, four_ranks[0]["mean"]["bf16"][k])


# ---------------------------------------------------------------------------
# compression round trips
# ---------------------------------------------------------------------------
def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 7)).astype(np.float32) * 3.0,
            "a": rng.standard_normal(512).astype(np.float32)}


def test_bf16_roundtrip_is_the_reference(world1):
    g = _grads()
    want = jax_compress({k: jnp.asarray(v) for k, v in g.items()}, "bf16")
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    got = compress_decompress(t, "bf16")
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # a world of 1 under a data mesh: the bf16 mean is the round trip
    with use_mesh(data_mesh(device="cpu")):
        mean = mean_grads_compressed(t, "bf16")
    for k in g:
        assert torch.equal(mean[k], got[k])
        assert torch.equal(t[k], torch.from_numpy(g[k]))    # not in place


def test_int8_roundtrip_is_the_reference_on_its_draws(monkeypatch):
    draws = []
    bernoulli = jax.random.bernoulli

    def spy(key, p=0.5, shape=None, **kw):
        out = bernoulli(key, p, shape, **kw)
        draws.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", spy)
    g = _grads(1)
    want = jax_compress({k: jnp.asarray(v) for k, v in g.items()}, "int8",
                        key=jax.random.PRNGKey(3))
    assert len(draws) == len(g)
    up = {k: torch.from_numpy(d.copy()) for k, d in zip(sorted(g), draws)}
    t = {k: torch.from_numpy(v) for k, v in g.items()}
    got = compress_decompress(t, "int8", up=up)
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # without a mesh, the mean is the round trip
    mean = mean_grads_compressed(t, "int8", up=up)
    for k in g:
        assert torch.equal(mean[k], got[k])
    with pytest.raises(ValueError):
        compress_decompress(t, "fp4")


@pytest.mark.parametrize("seed", [0, 17, 4242])
def test_int8_stochastic_rounding_unbiased(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy((rng.standard_normal(256)
                          * rng.uniform(0.1, 10)).astype(np.float32))
    outs = torch.stack([compress_decompress(
        {"a": a}, "int8", generator=torch.Generator().manual_seed(i))["a"]
        for i in range(32)])
    scale = float(a.abs().max()) / 127.0
    assert float((outs.mean(0) - a).abs().max()) < 1.2 * scale


def test_int8_mean_keeps_the_references_own_scale_bias(four_ranks):
    """ROADMAP Queue 3 #10: each rank scales the summed codes by its own
    scale, so ranks whose scales differ get different, biased means (the
    reference's behaviour, kept)."""
    grads = [worker.compress_grads(r) for r in range(N_RANKS)]
    exact = np.mean([g["a"][0] for g in grads])
    got = [r["mean"]["int8"]["a"][0] for r in four_ranks]
    assert len(set(got)) == N_RANKS
    assert all(abs(x - exact) > 0.5 for x in got)


def test_train_cli_refuses_the_unread_compress_grads_flag(capsys):
    """ROADMAP Queue 3 #11: the reference parses ``--compress-grads`` and
    never reads it; the port's CLI does not offer it, so asking for a
    compression fails in argparse instead of training uncompressed."""
    from repro_torch.launch import train
    with pytest.raises(SystemExit) as e:
        train.main(["--device", "cpu", "--dataset", "synth_xs", "--steps",
                    "1", "--compress-grads", "int8"])
    assert e.value.code == 2
    assert "--compress-grads" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the CLI under torchrun
# ---------------------------------------------------------------------------
def test_train_cli_under_torchrun_two_ranks(tmp_path):
    """Each rank's stdout goes to its own file (``--redirects 1``): on the
    one pipe they would share, the two ranks' last lines can interleave
    mid-line (a line's text and its newline are written apart), which
    broke the parse of one rank's recall now and then."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--redirects", "1", "--log-dir",
         str(tmp_path), "-m", "repro_torch.launch.train",
         "--device", "cpu", "--dataset", "synth_xs", "--steps", "8",
         "--batch-size", "256", "--chunk-size", "4", "--cluster-solver",
         "torch_sharded", "--trainer-backend", "fused_sharded"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    logs = sorted(tmp_path.rglob("stdout.log"),
                  key=lambda p: int(p.parent.name))
    assert [p.parent.name for p in logs] == ["0", "1"]
    out = "".join(p.read_text() for p in logs)
    for rank in (0, 1):
        assert f"backend=fused_sharded sampler=device chunk=4 device=cpu " \
               f"rank={rank}/2" in out
    assert out.count("(solver torch_sharded)") == 2
    recalls = [ln.split("recall@20=")[1].split()[0]
               for ln in out.splitlines() if "recall@20=" in ln]
    assert len(recalls) == 2 and recalls[0] == recalls[1]

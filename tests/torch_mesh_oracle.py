"""The JAX package's cells on 4 host devices: the oracle of
``tests/test_torch_mesh.py`` (the LM cells) and of
``tests/test_torch_mesh_cells.py`` (the recsys, cf and GNN cells).

    python tests/torch_mesh_oracle.py OUT.npz [DxM] [cells]

Run as a script, it sets ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
and ``JAX_PLATFORMS=cpu`` before importing jax, then runs, on each of the
(2, 2) and (1, 4) ``("data", "model")`` meshes built as
``jax.sharding.Mesh`` (Auto axes: under ``jax.make_mesh``'s Explicit
axes the reference's ``shard()`` raises), the smoke cells of
``MESH_ARCHS`` in f32: the prefill's logits and cache, one decode step's
logits and cache, and ``train_loss`` with its gradients; the qwen1.5-32b
prefill in bf16 on (2, 2); and ``build_pp_train_cell``'s step (loss and
updated params) for qwen1.5-32b at ``PP_LAYERS`` layers on both meshes.
Every array is written as float32 under ``"<mesh>/<arch>/<what>"``;
``DxM`` (``2x2`` or ``1x4``) runs one mesh only. ``cells`` runs, in place
of those, the smoke cells of ``CELLS`` on :func:`cell_inputs` (the
reference's smoke args, the batch's ids redrawn over their whole range):
a serve cell's output, a train cell's loss and gradients of its loss, by
``jax.jit`` under the mesh, under ``"<mesh>/<arch>:<shape>/<what>"``.
"""
import dataclasses
import functools
import importlib
import os
import sys

import numpy as np

MESHES = ((2, 2), (1, 4))
MESH_ARCHS = ("gemma2-9b", "qwen1.5-32b", "dbrx-132b")
# GPipe: qwen1.5-32b's smoke config at this depth, global batch, seq and
# microbatches
PP_LAYERS, PP_BATCH, PP_SEQ, PP_MICRO = 4, 8, 16, 4


def _path(keys) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in keys)


def _flat(tree, prefix: str, out: dict) -> None:
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for p, x in flat:
        out[f"{prefix}/{_path(p)}"] = np.asarray(x, np.float32)


def mesh_of(shape):
    import jax
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


def lm_cells(mesh, tag: str, out: dict, archs=MESH_ARCHS) -> None:
    import jax

    from repro.configs import registry
    from repro.launch import steps
    from repro.models import transformer as T

    for arch in archs:
        cfg = dataclasses.replace(registry.get_arch(arch).smoke_config(),
                                  lookup_backend="gather")
        pre = steps.build_cell(arch, "prefill_32k", smoke=True,
                               lookup_backend="gather")
        dec = steps.build_cell(arch, "decode_32k", smoke=True,
                               lookup_backend="gather")
        tr = steps.build_cell(arch, "train_4k", smoke=True,
                              lookup_backend="gather")
        with mesh:
            logits, cache = jax.jit(pre.fn)(*pre.args)
            _flat({"logits": logits, "cache": cache},
                  f"{tag}/{arch}/prefill", out)
            logits, cache = jax.jit(dec.fn)(*dec.args)
            _flat({"logits": logits, "cache": cache},
                  f"{tag}/{arch}/decode", out)
            params, _, batch = tr.args
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: T.train_loss(p, b, cfg)))(params, batch)
            _flat({"loss": loss, "grads": grads}, f"{tag}/{arch}/train", out)


def dp_cells(mesh, tag: str, out: dict) -> None:
    """gemma2-9b's smoke cells (the same args as :func:`lm_cells`) run
    under the reference's ``logical_mapping("dp")``: the batch over every
    axis, no tensor parallelism."""
    from repro.distributed.sharding import logical_mapping

    with logical_mapping("dp"):
        lm_cells(mesh, f"{tag}/dp", out, archs=("gemma2-9b",))
    for k in [k for k in out if k.startswith(f"{tag}/dp/gemma2-9b/")]:
        out[k.replace("/dp/gemma2-9b/", "/dp/")] = out.pop(k)


def bf16_prefill(mesh, tag: str, out: dict) -> None:
    """qwen1.5-32b's smoke prefill in bf16 (params ``init_params`` key 0
    cast by the config; tokens ``bf16_tokens``)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry
    from repro.models import transformer as T

    cfg = dataclasses.replace(registry.get_arch("qwen1.5-32b").smoke_config(),
                              dtype="bfloat16", lookup_backend="gather")
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    with mesh:
        logits, cache = jax.jit(functools.partial(T.prefill, cfg=cfg,
                                                  max_seq=16))(
            params, {"tokens": jnp.asarray(bf16_tokens())})
    _flat({"logits": logits, "cache": cache}, f"{tag}/bf16/prefill", out)


def bf16_tokens() -> np.ndarray:
    return np.random.default_rng(3).integers(0, 512, (4, 16)).astype(
        np.int32)


def pp_config():
    from repro.configs import registry
    return dataclasses.replace(registry.get_arch("qwen1.5-32b").smoke_config(),
                               n_layers=PP_LAYERS, lookup_backend="gather")


def pp_inputs(cfg):
    """GPipe's inputs: ``init_params`` key 0 and tokens, targets uniform
    over the vocabulary from ``default_rng(5)``."""
    import jax

    from repro.models import transformer as T
    params = T.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (PP_BATCH, PP_SEQ)).astype(
        np.int32) for k in ("tokens", "targets")}
    return params, batch


def pp_step(mesh, tag: str, out: dict) -> None:
    import jax

    from repro.launch.pipeline import build_pp_train_cell
    from repro.training import optimizer as opt_lib

    cfg = pp_config()
    n_stages = mesh.shape["model"]
    step, (p_specs, _, _) = build_pp_train_cell(
        cfg, global_batch=PP_BATCH, seq=PP_SEQ, mesh=mesh, n_micro=PP_MICRO)
    params, batch = pp_inputs(cfg)
    params = {**params, "blocks": jax.tree.map(
        lambda a: a.reshape((n_stages, a.shape[0] // n_stages)
                            + a.shape[1:]), params["blocks"])}
    params = jax.tree.map(lambda a, s: jax.device_put(a, s.sharding),
                          params, p_specs)
    opt_state = opt_lib.adamw(lr=3e-4, grad_clip=1.0).init(params)
    with mesh:
        new_params, _, loss = jax.jit(step)(params, opt_state, batch)
    new_params = {**new_params, "blocks": jax.tree.map(
        lambda a: a.reshape((-1,) + a.shape[2:]), new_params["blocks"])}
    _flat({"loss": loss, "params": new_params}, f"{tag}/pp", out)


# the recsys, cf and GNN smoke cells held on 4 ranks
CELLS = (("dlrm-mlperf", "serve_p99"), ("dlrm-mlperf", "train_batch"),
         ("dlrm-mlperf-baco", "train_batch"),
         ("wide-deep-baco", "train_batch"), ("sasrec-baco", "train_batch"),
         ("bert4rec-baco", "train_batch"), ("lightgcn-baco", "bpr_train"),
         ("schnet", "full_graph_sm"), ("schnet", "molecule"))


def _spread_batch(cfg, batch: dict, rng) -> dict:
    """The smoke batch with its ids uniform over their ranges (the smoke
    draws give every id 0 or 1, which one row block holds)."""
    b = dict(batch)

    def ids(hi, shape):
        return rng.integers(0, hi, shape).astype(np.int32)

    name = type(cfg).__name__
    if name in ("DLRMConfig", "WideDeepConfig"):
        b["sparse"] = np.stack([ids(v, b["sparse"].shape[0])
                                for v in cfg.vocabs], axis=1)
        if "label" in b:
            b["label"] = (rng.random(b["label"].shape) < 0.5).astype(
                np.float32)
    elif name in ("SASRecConfig", "BERT4RecConfig"):
        for k in ("seq", "neg", "target_ids", "neg_ids"):
            if k in b:
                b[k] = ids(cfg.n_items, b[k].shape)
        if "target_pos" in b:
            b["target_pos"] = ids(cfg.seq_len, b["target_pos"].shape)
    elif name == "LightGCNConfig":
        b["user"] = ids(cfg.n_users, b["user"].shape)
        b["pos"], b["neg"] = (ids(cfg.n_items, b[k].shape)
                              for k in ("pos", "neg"))
    else:                                           # SchNet
        n = (b["z"] if "z" in b else b["node_targets"]).shape[0]
        b["edge_src"], b["edge_dst"] = (ids(n, b[k].shape)
                                        for k in ("edge_src", "edge_dst"))
        b["edge_dist"] = rng.uniform(0.0, 1.2 * cfg.cutoff,
                                     b["edge_dist"].shape).astype(np.float32)
        if "z" in b:
            g = b["targets"].shape[0]
            b["z"] = ids(cfg.max_z, n)
            b["graph_id"] = (np.arange(n) // (n // g)).astype(np.int32)
        else:
            b["node_mask"] = (rng.random(n) < 0.5).astype(np.float32)
    return b


def cell_config(arch: str, shape: str):
    """The reference cell's config (SchNet's with its shape's d_feat)."""
    from repro.configs import registry
    spec = registry.get_arch(arch)
    cfg = dataclasses.replace(spec.smoke_config(), lookup_backend="gather")
    if spec.family == "gnn":
        cfg = dataclasses.replace(cfg, d_feat=0 if shape == "molecule"
                                  else 16)
    return cfg


def cell_inputs(arch: str, shape: str):
    """(the reference's smoke cell, its args as numpy with the batch
    spread by ``default_rng(7)``)."""
    import jax

    from repro.launch import steps
    ref = steps.build_cell(arch, shape, smoke=True, lookup_backend="gather")
    args = jax.tree.map(np.asarray, ref.args)
    rng = np.random.default_rng(7)
    return ref, tuple(args[:-1]) + (
        _spread_batch(cell_config(arch, shape), args[-1], rng),)


def cell_loss(arch: str, shape: str):
    """The reference train cell's loss, (params, statics, batch) ->
    scalar (SchNet's ignores the statics)."""
    from repro.configs import registry
    from repro.models import lightgcn as LG
    from repro.models import recsys as R
    from repro.models import schnet as S

    cfg = cell_config(arch, shape)
    family = registry.get_arch(arch).family
    if family == "gnn":
        fn = S.train_loss if shape == "molecule" else S.node_train_loss
        return lambda p, s, b: fn(p, b, cfg)
    if family == "cf":
        return lambda p, s, b: LG.bpr_loss_fn(p, s, b, cfg)
    name = {"DLRMConfig": "dlrm", "WideDeepConfig": "widedeep",
            "SASRecConfig": "sasrec",
            "BERT4RecConfig": "bert4rec"}[type(cfg).__name__]
    fn = getattr(R, f"{name}_train_loss")
    return lambda p, s, b: fn(p, s, b, cfg)


def mesh_cells(mesh, tag: str, out: dict) -> None:
    import jax

    jitted = {}          # cells of one smoke config share a compilation
    for arch, shape in CELLS:
        ref, args = cell_inputs(arch, shape)
        pre = f"{tag}/{arch}:{shape}"
        key = (repr(cell_config(arch, shape)), shape)
        with mesh:
            if ref.kind != "train":
                _flat({"out": jax.jit(ref.fn)(*args)}, pre, out)
                continue
            if key not in jitted:
                jitted[key] = jax.jit(jax.value_and_grad(
                    cell_loss(arch, shape)))
            statics = args[2] if len(args) == 4 else None
            loss, grads = jitted[key](args[0], statics, args[-1])
        _flat({"loss": loss, "grads": grads}, pre, out)


def main(argv) -> int:
    import jax

    from repro.configs import registry
    for m in registry._MODULES:
        importlib.import_module(f"repro.configs.{m}")
    assert len(jax.devices()) == 4, jax.devices()
    out = {}
    for shape in MESHES:
        tag = f"{shape[0]}x{shape[1]}"
        if len(argv) > 2 and argv[2] != tag:
            continue
        mesh = mesh_of(shape)
        if len(argv) > 3 and argv[3] == "cells":
            mesh_cells(mesh, tag, out)
            continue
        lm_cells(mesh, tag, out)
        dp_cells(mesh, tag, out)
        pp_step(mesh, tag, out)
        if shape == (2, 2):
            bf16_prefill(mesh, tag, out)
    np.savez(argv[1], **out)
    return 0


if __name__ == "__main__":
    # before jax is first imported: 4 host devices, the CPU only (never
    # at import, which would give the importing process 4 devices too)
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               " --xla_force_host_platform_device_count=4")
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.exit(main(sys.argv))

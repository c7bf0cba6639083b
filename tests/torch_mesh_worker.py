"""One gloo rank of ``tests/test_torch_mesh.py``'s 4-rank world.

    python tests/torch_mesh_worker.py RANK WORLD STORE_FILE OUT_DIR INPUTS

Every rank joins the world through a file store and, on each of the
(2, 2) and (1, 4) ("data", "model") meshes, runs through the port's
entry points the smoke cells of the five LM archs on the JAX package's
inputs (``INPUTS``, an ``.npz`` the test writes: each arch's params, each
cell's batch, the decode cache; the pipeline's and the bf16 case's): the
prefill's logits and cache, one decode step's, the train cell's loss
and gradients (``Cell.fn.value_and_grad``) and its params after one
step; the token embedding on the mesh against the one-card lookup
(bitwise); ``build_pp_train_cell``'s step; on (2, 2) the bf16 qwen
prefill and a MoE whose experts do not divide the model axis (the
reference's fallback) against its one-card loss and gradients; and the
compressed gradient mean over a 2-D and a 3-D mesh's batch axes. The
data-axis layouts: gemma2-9b's cells under the "dp" mapping
(:func:`dp_cells`), train cells with FSDP forced beside the same cells
without it (:func:`fsdp_cells`), and a step of kimi-k2's smoke config at
128 experts, the reference's Adafactor route (:func:`adafactor_step`).
Rank 0 pickles what it saw, gathered whole, to ``OUT_DIR/rank0.pkl``.
Imports nothing of JAX.
"""
import dataclasses
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

MESHES = ((2, 2), (1, 4))
ARCHS = ("gemma2-9b", "gemma3-12b", "qwen1.5-32b", "dbrx-132b",
         "kimi-k2-1t-a32b")
SHAPES = {"prefill": "prefill_32k", "decode": "decode_32k",
          "train": "train_4k"}
# the pipeline's config (qwen1.5-32b's smoke config at this depth), batch,
# sequence and microbatches, as tests/torch_mesh_oracle.py runs it
PP_LAYERS, PP_BATCH, PP_SEQ, PP_MICRO = 4, 8, 16, 4
# the MoE fallback's experts: 3 do not divide a model axis of 2
FALLBACK_EXPERTS = 3
# kimi-k2's smoke config at this many experts takes the reference's
# Adafactor (128 or more)
ADAFACTOR_EXPERTS = 128
# the train cells run with FSDP forced
FSDP_ARCHS = ("gemma2-9b", "dbrx-132b")


def dp_shape(kind: str):
    """A smoke shape of ``kind`` under the "dp" mapping (no registered
    shape takes it: the reference's EXPERIMENTS variant)."""
    from repro_torch.configs.registry import ShapeSpec
    return ShapeSpec(f"{kind}_dp", kind, dict(seq_len=16, global_batch=4,
                                              mapping="dp"))


def adafactor_spec():
    """kimi-k2's arch with its smoke config at ``ADAFACTOR_EXPERTS``
    experts (1.6 M params)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import MoEConfig

    spec = get_arch("kimi-k2-1t-a32b")
    base = spec.smoke_config()
    cfg = dataclasses.replace(base, moe=MoEConfig(ADAFACTOR_EXPERTS, 2, 1.5),
                              lookup_backend="gather")
    return dataclasses.replace(spec, smoke_config=lambda: cfg)


def nested(flat: dict) -> dict:
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def load_inputs(path: str) -> dict:
    """{arch: {"params", "prefill", "decode", "train"}, "pp", "bf16"} as
    tensors: int arrays as int32, float32 as they are; ``*.bf16`` trees
    cast to bfloat16 (exact: the values are bf16 widened)."""
    z = np.load(path)
    flat = {}
    for k in z.files:
        t = torch.from_numpy(np.array(z[k]))
        if k.startswith("bf16/params/"):
            t = t.to(torch.bfloat16)
        flat[k] = t
    return nested(flat)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()


def lm_cells(mesh, arch: str, inp: dict) -> dict:
    from repro_torch.distributed import parallel as par
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T

    out = {}
    kw = dict(mesh=mesh, smoke=True, device="cpu", lookup_backend="gather")
    params = inp["params"]
    cell = build_cell(arch, SHAPES["prefill"], **kw,
                      args=(clone(params), clone(inp["prefill"]["batch"])))
    logits, cache = cell.fn(*cell.args)
    out["prefill"] = {"logits": logits, "cache": cell.gather("cache", cache)}

    a = inp["decode"]
    cell = build_cell(arch, SHAPES["decode"], **kw,
                      args=(clone(params), clone(a["cache"]),
                            clone(a["batch"])))
    logits, cache = cell.fn(*cell.args)
    out["decode"] = {"logits": logits, "cache": cell.gather("cache", cache),
                     "notes": cell.notes}

    cell = build_cell(arch, SHAPES["train"], **kw,
                      args=(clone(params), None, clone(inp["train"]["batch"])))
    local, _, b = cell.args
    step = cell.fn
    cfg = step.cfg
    with par.use_groups(step.groups):
        x = T._embed(local, b["tokens"], cfg, step.groups)
    want = T._embed(params, b["tokens"], cfg)
    out["embed_bitwise"] = bool(torch.equal(x, want))
    loss, grads = step.value_and_grad(local, b)
    layouts = R.flat_params(cell.layouts["params"])
    out["train"] = {"loss": loss, "grads": {
        k: layouts[k].gather(g) for k, g in grads.items()}}
    _, _, step_loss = cell.fn(*cell.args)
    out["train"]["step_loss"] = step_loss
    out["train"]["params"] = R.flat_params(cell.gather("params", local))
    out["train"]["notes"] = cell.notes
    return out


def dp_cells(mesh, inp: dict) -> dict:
    """gemma2-9b's smoke cells under the "dp" mapping on its inputs:
    prefill and decode logits and caches, the train loss, gradients and
    updated params."""
    import torch

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.steps import _lm_cell
    from repro_torch.models import recsys as R

    spec = get_arch("gemma2-9b")
    cpu = torch.device("cpu")
    out = {}
    params = inp["params"]
    for kind, extra in (("prefill", ()), ("decode", ("cache",))):
        args = (clone(params),) + tuple(clone(inp[kind][k]) for k in extra) \
            + (clone(inp[kind]["batch"]),)
        cell = _lm_cell(spec, dp_shape(kind), True, "gather", cpu, mesh=mesh,
                        args=args)
        logits, cache = cell.fn(*cell.args)
        out[kind] = {"logits": logits, "cache": cell.gather("cache", cache),
                     "notes": cell.notes}
    cell = _lm_cell(spec, dp_shape("train"), True, "gather", cpu, mesh=mesh,
                    args=(clone(params), None, clone(inp["train"]["batch"])))
    loss, grads = cell.fn.value_and_grad(cell.args[0], cell.args[2])
    layouts = R.flat_params(cell.layouts["params"])
    out["train"] = {"loss": loss, "grads": {
        k: layouts[k].gather(g) for k, g in grads.items()},
        "notes": cell.notes}
    _, _, out["train"]["step_loss"] = cell.fn(*cell.args)
    out["train"]["params"] = R.flat_params(cell.gather("params",
                                                       cell.args[0]))
    return out


def fsdp_cells(mesh, arch: str, inp: dict) -> dict:
    """The smoke train cell with FSDP forced (the threshold patched, the
    accumulator held at f32) and without it, on the same inputs: loss,
    gradients (gathered) and updated params (gathered) of each."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import recsys as R

    out = {}
    rule = steps.lm_fsdp
    for name, forced in (("fsdp", True), ("plain", False)):
        if forced:
            steps.lm_fsdp = lambda cfg, mesh=None, mapping="tp": True
        try:
            cell = steps.build_cell(
                arch, SHAPES["train"], mesh=mesh, smoke=True, device="cpu",
                lookup_backend="gather",
                args=(clone(inp["params"]), None,
                      clone(inp["train"]["batch"])))
        finally:
            steps.lm_fsdp = rule
        assert cell.fn.acc_dtype == torch.float32 or forced
        cell.fn.acc_dtype = torch.float32
        loss, grads = cell.fn.value_and_grad(cell.args[0], cell.args[2])
        layouts = R.flat_params(cell.layouts["params"])
        res = {"loss": loss, "notes": cell.notes,
               "grads": {k: layouts[k].gather(g) for k, g in grads.items()},
               "split": sorted(cell.fn.groups.params)}
        _, _, res["step_loss"] = cell.fn(*cell.args)
        res["params"] = R.flat_params(cell.gather("params", cell.args[0]))
        out[name] = res
    return out


def adafactor_step(mesh) -> dict:
    """One train step of kimi-k2's smoke config at 128 experts on the
    mesh (Adafactor over the experts' model axis): the params before,
    the loss and gradients, the params after, all gathered."""
    import torch

    from repro_torch.launch.steps import _lm_cell
    from repro_torch.models import recsys as R

    spec = adafactor_spec()
    cell = _lm_cell(spec, spec.shape("train_4k"), True, "gather",
                    torch.device("cpu"), mesh=mesh)
    params0 = R.flat_params(cell.gather("params", clone(cell.args[0])))
    loss, grads = cell.fn.value_and_grad(cell.args[0], cell.args[2])
    layouts = R.flat_params(cell.layouts["params"])
    out = {"params0": params0, "loss": loss, "notes": cell.notes,
           "grads": {k: layouts[k].gather(g) for k, g in grads.items()}}
    _, _, out["step_loss"] = cell.fn(*cell.args)
    out["params"] = R.flat_params(cell.gather("params", cell.args[0]))
    return out


def pp_step(mesh, inp: dict) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.pipeline import build_pp_train_cell
    from repro_torch.models import recsys as R

    cfg = dataclasses.replace(get_arch("qwen1.5-32b").smoke_config(),
                              n_layers=PP_LAYERS, lookup_backend="gather")
    cell = build_pp_train_cell(cfg, global_batch=PP_BATCH, seq=PP_SEQ,
                               mesh=mesh, n_micro=PP_MICRO, device="cpu",
                               args=(clone(inp["params"]),
                                     clone(inp["batch"])))
    _, _, loss = cell.fn(*cell.args)
    return {"loss": loss,
            "params": R.flat_params(cell.gather("params", cell.args[0]))}


def bf16_prefill(mesh, inp: dict) -> dict:
    """qwen1.5-32b's smoke prefill in bf16 on the reference's params,
    through the model functions on this rank's blocks."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import parallel as par
    from repro_torch.launch.steps import _local_rows, _map_layouts
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch("qwen1.5-32b").smoke_config(),
                              dtype="bfloat16", lookup_backend="gather")
    tokens = inp["tokens"]
    with par.use_groups(None):
        groups = par.rank_groups(mesh, tokens.shape[0])
    params = _map_layouts(lambda lay, t: lay.local_block(t),
                          T.param_layouts(cfg, mesh), inp["params"])
    with par.use_groups(groups), torch.inference_mode():
        logits, cache = T.prefill(params, {"tokens": _local_rows(
            tokens, groups)}, cfg, max_seq=tokens.shape[1])
    return {"logits": logits}


def moe_fallback(mesh) -> dict:
    """dbrx-132b's smoke config with ``FALLBACK_EXPERTS`` experts: the
    train loss and gradients on the mesh, and on one rank unsharded."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.distributed import parallel as par
    from repro_torch.launch.steps import _local_rows, _map_layouts
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T

    base = get_arch("dbrx-132b").smoke_config()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=FALLBACK_EXPERTS), lookup_backend="gather")
    full = T.init_params(torch.Generator().manual_seed(1), cfg)
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (4, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "targets")}
    layouts = T.param_layouts(cfg, mesh)
    local = _map_layouts(lambda lay, t: lay.local_block(t).clone(), layouts,
                         full)
    with par.use_groups(None):
        groups = par.rank_groups(mesh, 4)
    out = {}
    for name, p, b, grp in (("mesh", local, {k: _local_rows(v, groups)
                                             for k, v in batch.items()},
                             groups),
                            ("one", full, batch, None)):
        flat = R.flat_params(p)
        for t in flat.values():
            t.requires_grad_(True)
        with par.use_groups(grp):
            loss = T.train_loss(p, b, cfg)
        grads = torch.autograd.grad(loss, list(flat.values()))
        if grp is not None:
            for x in grads:
                par.all_reduce(x, grp.data_group)
            lays = R.flat_params(layouts)
            grads = [lays[k].gather(x) for k, x in zip(flat, grads)]
        out[name] = {"loss": loss.detach(), "grads": dict(zip(flat, grads))}
    return out


def compress_means(rank: int) -> dict:
    """``mean_grads_compressed`` over the batch axes of a (2, 2) mesh and
    of a (1, 2, 2) one (pod and data flattened): rank 0 averages with
    rank 2, over 2 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import use_mesh
    from repro_torch.training.compress import mean_grads_compressed
    from torch_sharded_worker import compress_grads

    grads = {k: torch.from_numpy(v) for k, v in compress_grads(rank).items()}
    out = {}
    for shape, names in (((2, 2), ("data", "model")),
                         ((1, 2, 2), ("pod", "data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        with use_mesh(mesh):
            out["x".join(map(str, shape))] = {
                m: mean_grads_compressed(grads, m) for m in ("bf16", "int8")}
    return out


def run(rank: int, world: int, inputs: dict) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    out = {"seconds": {}, "compress": compress_means(rank)}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        tag = f"{shape[0]}x{shape[1]}"
        res = {}
        for arch in ARCHS:
            t0 = time.perf_counter()
            res[arch] = lm_cells(mesh, arch, inputs[arch])
            out["seconds"][f"{tag}/{arch}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["pp"] = pp_step(mesh, inputs["pp"])
        out["seconds"][f"{tag}/pp"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["dp"] = dp_cells(mesh, inputs["gemma2-9b"])
        res["fsdp"] = {a: fsdp_cells(mesh, a, inputs[a]) for a in FSDP_ARCHS}
        res["adafactor"] = adafactor_step(mesh)
        out["seconds"][f"{tag}/data_axes"] = time.perf_counter() - t0
        if shape == (2, 2):
            res["bf16"] = bf16_prefill(mesh, inputs["bf16"])
            res["fallback"] = moe_fallback(mesh)
        out[tag] = res
    return out


def main(argv) -> int:
    rank, world = int(argv[1]), int(argv[2])
    store, out_dir, inputs = argv[3], argv[4], argv[5]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = run(rank, world, load_inputs(inputs))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(f"{out_dir}/rank0.pkl", "wb") as f:
            pickle.dump(np_tree_any(out), f)
    return 0


def np_tree_any(x):
    """Tensors as float32 numpy arrays, through dicts; the rest as is."""
    if isinstance(x, dict):
        return {k: np_tree_any(v) for k, v in x.items()}
    if torch.is_tensor(x):
        return x.detach().float().numpy().copy()
    return x


if __name__ == "__main__":
    sys.exit(main(sys.argv))

"""Per-rank FLOPs, bytes and collectives of one call of a step (the
port's counterpart of ``benchmarks/hlo_analysis.py``).

:class:`OpAnalysis` is a ``TorchDispatchMode``: every aten op a step runs
while it is entered passes through it and is counted as it runs. The
reference walks the compiled HLO and scales each op by its loop's trip
count; the port runs eagerly, so a loop's body is simply run, and
counted, as many times as it runs. The keys are the reference's:

  ``dot_flops``                2 x the multiply-adds of every matmul,
                               batched matmul, linear, einsum and
                               convolution; ``dot_flops/<dtype>`` split by
                               the operands' dtype ("f32", "bf16", ...)
  ``hbm_bytes``                the bytes each op that moves data reads and
                               writes: its tensor operands and outputs, as
                               shaped. Views, ``empty`` and metadata ops
                               count none, nor do ops with no tensor on
                               the arguments' device (host-side index
                               building of a device step), nor buffers
                               that only the CPU and meta kernels fill
                               (:func:`_host_only_bytes`). This is what the program does,
                               op by op, so there is no lower and upper
                               bracket: the reference brackets its memory
                               term only because the CPU HLO it reads
                               cannot show a TPU's fusion
                               (``benchmarks/roofline.py:143-157``).
  ``coll_bytes/<kind>``        operand bytes of each collective
  ``coll_bytes_total``         (``hlo_analysis.py:254``), kind
                               "all-reduce", "all-gather",
                               "reduce-scatter" or "collective-permute";
                               note that ``parallel.COUNTS`` counts an
                               all-gather's output instead
and it adds:
  ``coll_bytes/nvlink``,       the same bytes by link: NVLink when every
  ``coll_bytes/network``       rank of the group sits in one node of
                               ``NODE_SIZE`` (8) consecutive ranks, else the
                               network
  ``kernels``                  calls of the port's six kernels by name;
  ``kernel_ops/f32``,          each call counts once, with its
  ``kernel_ops/16``            ``kernels.cost`` bytes (in ``hbm_bytes``)
                               and operations, whether it launches the
                               CUDA kernel, runs its plain version on the
                               CPU or runs on meta tensors; nothing that
                               runs inside the wrapper counts on top
  ``host_reads``               reads of a device tensor on the host
                               (``aten._local_scalar_dense``, a copy to
                               the CPU)
  ``memory``                   ``argument_size_in_bytes`` (the storages of
                               the arguments :meth:`OpAnalysis.arguments`
                               names), ``output_size_in_bytes`` (the
                               storages of the outputs :meth:`finish`
                               names that are not arguments') and
                               ``temp_size_in_bytes`` (the peak of the live
                               storages the step made: every argument is
                               left out)

``torch.utils.checkpoint``'s recomputation counts as it runs, as XLA's
rematerialization does.

On meta tensors (``launch.dryrun``'s reckoning) the mode answers a host
read as a valid input would: every range check passes. Where a read
steers the work it takes the branch that does more work and records the
branch under ``branches``. It knows the reads of the port by the
function they sit in (:data:`READS`); any other read of a meta tensor
(one that would size a tensor, say) raises, naming the op and the line.
A functional op's meta outputs are cached by the metadata of its inputs,
so a repeated layer costs a lookup, not a shape function.
"""
from __future__ import annotations

import math
import os
import sys
from collections import defaultdict
from typing import Optional

import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost as kcost

__all__ = ["OpAnalysis", "READS", "count", "dtype_name", "NODE_SIZE"]

aten = torch.ops.aten
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODE_SIZE = 8                   # GPUs a node (an H100 SXM board)

_DTYPE = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
          torch.float16: "f16", torch.float8_e4m3fn: "f8e4m3fn",
          torch.float8_e5m2: "f8e5m2", torch.int8: "s8", torch.int32: "s32",
          torch.int64: "s64", torch.uint8: "u8", torch.bool: "pred"}


def dtype_name(dtype: torch.dtype) -> str:
    """HLO's name of a dtype ("f32", "bf16", ...)."""
    return _DTYPE.get(dtype, str(dtype).split(".")[-1])


# ops that make no data move: allocation and metadata
_NO_BYTES = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default, aten._local_scalar_dense.default,
             aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
             aten.is_contiguous.default}

_COLLECTIVES = {"allreduce_": "all-reduce",
                "allreduce_coalesced_": "all-reduce",
                "_allgather_base_": "all-gather",
                "allgather_": "all-gather",
                "allgather_into_tensor_coalesced_": "all-gather",
                "_reduce_scatter_base_": "reduce-scatter",
                "reduce_scatter_": "reduce-scatter",
                "reduce_scatter_tensor_coalesced_": "reduce-scatter",
                "send": "collective-permute",
                "alltoall_base_": "all-to-all",
                "broadcast_": "collective-broadcast"}


# a device tensor read as a host scalar (``item``, ``bool``: ``is_nonzero``
# where autograd does not decompose it first)
_SCALAR_READS = {aten._local_scalar_dense.default, aten.is_nonzero.default,
                 aten.item.default}
# copies whose target device is an argument (position) or a keyword
_COPIES = {aten._to_copy.default: None, aten.to.dtype_layout: None,
           aten.to.device: 1, aten.to.prim_Device: 1}


def _read_source(func, args, kwargs):
    """The device tensor ``func`` reads on the host, or None."""
    if func in _SCALAR_READS:
        src = args[0]
    elif func in _COPIES:
        pos = _COPIES[func]
        dev = (kwargs.get("device") if pos is None else
               (args[pos] if len(args) > pos else kwargs.get("device")))
        if dev is None or torch.device(dev).type != "cpu":
            return None
        src = args[0]
    elif func is aten.copy_.default:
        if args[0].device.type != "cpu":
            return None
        src = args[1]
    else:
        return None
    return src if src.device.type != "cpu" else None


def _host_only_bytes(func, args, out) -> int:
    """Bytes an op's CPU and meta kernels move that the card's does not:
    ``log_sigmoid_forward``'s buffer for its backward is empty on the card
    (``[0]``) and [N] on the CPU and on meta. It counts on no device, so
    the three counts agree; the temporaries keep it (within the smoke's
    tolerance)."""
    if func is aten.log_sigmoid_forward.default:
        return _nbytes(out[1])
    if func is aten.log_sigmoid_backward.default:
        return _nbytes(args[2])
    return 0


def _answer_false(frame, t):
    """A range check that passes."""
    return False


def _answer_sorted_bags(frame, t):
    """``embedding_bag``'s five reads: unsorted (True: the stable sort
    runs, the more work), then four range checks that pass."""
    return [True, False, False, False, False]


def _answer_sketch_range(frame, t):
    """``fused_topk._check_sketch``'s (lowest, highest) entry of a sketch
    that is in range."""
    return [0, int(frame.f_locals["k_rows"]) - 1]


# (module of the port, function) -> (what the read decides, its answer on
# meta tensors)
READS = {
    ("kernels/ops.py", "full"): ("check: ids in range", _answer_false),
    ("models/recsys.py", "_check_ids"): ("check: ids in range",
                                         _answer_false),
    ("kernels/embedding_bag.py", "embedding_bag"): (
        "branch: unsorted bags are sorted", _answer_sorted_bags),
    ("kernels/fused_topk.py", "_check_sketch"): ("check: sketch in range",
                                                 _answer_sketch_range),
}


def _site():
    """The innermost frame of the port's own code outside this module."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_PKG) and not name.endswith("op_analysis.py"):
            return f
        f = f.f_back
    return None


def _leaves(x, out: list) -> list:
    """The leaves of nested lists, tuples and dicts (a lean
    ``tree_flatten`` for op arguments)."""
    if isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _tensors(x) -> list:
    return [t for t in _leaves(x, []) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _flops(func, args, out) -> tuple:
    """(flops, operand dtype) of a dot-like op, or None."""
    name = func.overloadpacket.__name__
    if name in ("mm", "bmm", "matmul", "dot", "mv", "_scaled_mm"):
        a = args[0]
    elif name in ("addmm", "baddbmm", "addmv", "addbmm"):
        a = args[1]
    elif name == "linear":
        a = args[0]
    elif name == "convolution":
        from torch.utils.flop_counter import conv_flop_count
        x, w = args[0], args[1]
        return (conv_flop_count(list(x.shape), list(w.shape),
                                list(out.shape), args[6]), x.dtype)
    elif name == "einsum":
        return _einsum_flops(args[0], args[1]), args[1][0].dtype
    else:
        return None
    n_out = out.numel() if isinstance(out, torch.Tensor) else 1
    if name == "addbmm":                  # sums over the batch too
        n_out *= a.shape[0]
    return 2.0 * n_out * (a.shape[-1] if a.dim() else 1), a.dtype


def _einsum_flops(eq: str, operands) -> float:
    """2 x the product of every index's size: a contraction of two
    operands."""
    lhs = eq.replace(" ", "").split("->")[0].split(",")
    sizes = {}
    for term, t in zip(lhs, operands):
        dims = list(t.shape)
        if "..." in term:
            head, tail = term.split("...")
            n_ell = t.dim() - len(head) - len(tail)
            letters = list(head) + [f".{i}" for i in range(n_ell)] \
                + list(tail)
        else:
            letters = list(term)
        for c, n in zip(letters, dims):
            sizes[c] = max(sizes.get(c, 1), n)
    return 2.0 * math.prod(sizes.values())


# in-place ops that change a tensor's shape or strides: never cached
_RESHAPES_INPLACE = {"resize_", "resize_as_", "set_", "as_strided_",
                     "squeeze_", "unsqueeze_", "transpose_", "t_",
                     "swapdims_", "swapaxes_", "_resize_output_"}


def _op_kind(func) -> str:
    """"mutating", "view" (an output may alias an input), "functional"
    (fresh tensor outputs) or "other" (non-tensor outputs, or an op that
    reshapes a tensor in place)."""
    schema = func._schema
    if func.overloadpacket.__name__ in _RESHAPES_INPLACE:
        return "other"
    if schema.is_mutable:
        return "mutating"
    rets = schema.returns
    if any(r.alias_info is not None for r in rets):
        return "view"
    for r in rets:
        if "Tensor" not in str(r.type):
            return "other"
    return "functional"


def _key_of(x):
    """A hashable key of an op argument's metadata, or raise TypeError."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_key_of(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.layout,
                                   torch.memory_format)):
        return (type(x), x)
    raise TypeError(type(x))


class OpAnalysis(TorchDispatchMode):
    """The count of one call (module docstring)."""

    def __init__(self):
        super().__init__()
        self.m = defaultdict(float)
        self.kernels = defaultdict(int)
        self.host_reads = 0
        self.branches = []
        self._paused = 0
        self._kinds = {}
        self._memo = {}
        self._args = set()
        self._arg_bytes = 0
        self._live = {}                 # storage id -> (weak ref, bytes)
        self._live_bytes = 0            # an upper bound until a rescan
        self._peak = 0
        self._out_bytes = 0
        self._groups = {}
        self._device = None             # the arguments' device type

    # -- the step's arguments and outputs ---------------------------------
    def arguments(self, *trees) -> "OpAnalysis":
        """Name the step's arguments (any trees of tensors): their
        storages are ``argument_size_in_bytes`` and never temporaries."""
        for tree in trees:
            for t in _tensors(tree):
                if self._device in (None, "cpu"):
                    self._device = t.device.type
                if _sid(t) not in self._args:
                    self._args.add(_sid(t))
                    self._arg_bytes += t.untyped_storage().nbytes()
        return self

    def finish(self, out) -> "OpAnalysis":
        """Name the step's outputs: the storages among them that are not
        arguments' are ``output_size_in_bytes``."""
        seen = set()
        for t in _tensors(out):
            s = _sid(t)
            if s not in self._args and s not in seen:
                seen.add(s)
                self._out_bytes += t.untyped_storage().nbytes()
        return self

    # -- kernels -----------------------------------------------------------
    def kernel(self, name: str, c: kcost.Cost, fn, *args, **kwargs):
        """One call of a kernel wrapper (``kernels.cost.observe``): counted
        at its cost; nothing inside it is counted, and its outputs are
        the only storages it adds."""
        self.kernels[name] += 1
        self.m["hbm_bytes"] += c.bytes
        self.m["kernel_ops/f32"] += c.ops
        self.m["kernel_ops/16"] += c.ops16
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        for t in _tensors(out):          # the kernel's own outputs
            self._allocated(t, _nbytes(t))
        return out

    def __enter__(self):
        self._prev_observer = kcost.observer
        kcost.observer = self
        return super().__enter__()

    def __exit__(self, *exc):
        kcost.observer = self._prev_observer
        return super().__exit__(*exc)

    # -- memory ------------------------------------------------------------
    def _allocated(self, t: torch.Tensor, nbytes: Optional[int] = None):
        """A storage the step made (on the arguments' device), of its own
        bytes or ``nbytes``."""
        s = _sid(t)
        if s in self._args or (self._device is not None
                               and t.device.type != self._device):
            return
        if s in self._live:
            if not self._live[s][0].expired():
                return                  # a storage already counted
            # a dead storage's address taken by a new one
            self._live_bytes -= self._live.pop(s)[1]
        st = t.untyped_storage()
        nb = st.nbytes() if nbytes is None else nbytes
        self._live[s] = (StorageWeakRef(st), nb)
        self._live_bytes += nb
        if self._live_bytes > self._peak:
            self._rescan()
            self._peak = max(self._peak, self._live_bytes)

    def _rescan(self) -> None:
        dead = [s for s, (ref, _) in self._live.items() if ref.expired()]
        for s in dead:
            self._live_bytes -= self._live.pop(s)[1]

    # -- host reads ----------------------------------------------------------
    def _host_read(self, func, src: torch.Tensor, args, kwargs):
        """A read of a device tensor on the host: counted; on a meta
        tensor answered from :data:`READS`."""
        self.host_reads += 1
        if src.device.type != "meta":
            return func(*args, **kwargs)
        frame = _site()
        key = None
        if frame is not None:
            rel = os.path.relpath(frame.f_code.co_filename, _PKG)
            key = (rel.replace(os.sep, "/"), frame.f_code.co_name)
        if key not in READS:
            where = ("an unknown caller" if frame is None else
                     f"{key[0]}:{frame.f_lineno} ({key[1]})")
            raise RuntimeError(
                f"op analysis: {func} reads a meta tensor of shape "
                f"{tuple(src.shape)} on the host at {where}; no answer is "
                f"known for this read (one that sizes a tensor cannot be "
                f"reckoned without data)")
        what, answer = READS[key]
        value = answer(frame, src)
        if what.startswith("branch") and (key, what) not in [
                (b["site"], b["took"]) for b in self.branches]:
            self.branches.append({"site": key, "took": what})
        if func in _SCALAR_READS:
            return bool(value) if func is aten.is_nonzero.default else value
        host = torch.tensor(value, dtype=src.dtype).reshape(src.shape)
        return args[0].copy_(host) if func is aten.copy_.default else host

    # -- the dispatch ----------------------------------------------------------
    def _run(self, func, kind, args, kwargs, flat, tensors):
        """Run ``func``; a functional (or fresh-output) op on meta inputs is
        answered from the cache of its inputs' metadata (``flat``: the
        leaves of its arguments, ``tensors`` the tensors among them)."""
        if kind == "other" or not tensors or any(
                t.device.type != "meta" for t in tensors):
            return func(*args, **kwargs)
        try:
            key = (func, _key_of(flat))
        except TypeError:
            return func(*args, **kwargs)
        hit = self._memo.get(key)
        if hit is not None:
            if hit[0] == "alias":
                return flat[hit[1]] if hit[2] is None else \
                    tuple(flat[i] for i in hit[1])
            outs = [torch.empty_strided(s, st, dtype=d, device="meta")
                    for s, st, d in hit[1]]
            return outs[0] if hit[2] is None else hit[2](outs)
        out = func(*args, **kwargs)
        self._remember(key, flat, out)
        return out

    def _remember(self, key, flat, out) -> None:
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if not outs or not all(isinstance(o, torch.Tensor) for o in outs):
            return
        pack = None if not isinstance(out, (tuple, list)) else type(out)
        ids = [next((i for i, x in enumerate(flat) if x is o), None)
               for o in outs]
        if all(i is not None for i in ids):
            self._memo[key] = ("alias", ids[0] if pack is None else ids,
                                None if pack is None else pack)
            return
        in_sids = {_sid(x) for x in flat if isinstance(x, torch.Tensor)}
        if any(i is not None or _sid(o) in in_sids
               for i, o in zip(ids, outs)):
            return                         # a view or a partial alias
        if any(o.storage_offset() or (
                o.numel() and o.untyped_storage().nbytes() != _nbytes(o))
               for o in outs):
            return                         # not a plain fresh tensor
        specs = [(tuple(o.shape), o.stride(), o.dtype) for o in outs]
        self._memo[key] = ("fresh", specs,
                            None if pack is None else pack)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        src = _read_source(func, args, kwargs)
        if src is not None:
            return self._host_read(func, src, args, kwargs)
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _op_kind(func)
        flat = _leaves((args, kwargs), [])
        ins = [x for x in flat if isinstance(x, torch.Tensor)]
        out = self._run(func, kind, args, kwargs, flat, ins)
        if self._paused:
            return out
        ns = func.namespace
        if ns == "c10d":
            self._collective(func, args)
            return out
        outs = _tensors(out)
        if self._device is not None and not any(
                t.device.type == self._device for t in ins + outs):
            return out                  # host-side work of a device step
        in_sids = {_sid(x) for x in ins}
        fresh = [o for o in outs if _sid(o) not in in_sids]
        for o in fresh:
            self._allocated(o)
        if func in _NO_BYTES:
            return out
        if fresh or kind == "mutating":
            self.m["hbm_bytes"] += (sum(_nbytes(x) for x in ins)
                                    + sum(_nbytes(o) for o in outs)
                                    - _host_only_bytes(func, args, out))
        f = _flops(func, args, out) if fresh else None
        if f is not None:
            self.m["dot_flops"] += f[0]
            self.m[f"dot_flops/{dtype_name(f[1])}"] += f[0]
        return out

    def _collective(self, func, args) -> None:
        name = func.overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        if kind is None:
            return                              # barrier, wait, ...
        if name in ("_allgather_base_", "_reduce_scatter_base_"):
            operands = [args[1]]
        elif name == "alltoall_base_":
            operands = [args[1]]
        elif name == "send":
            operands = list(args[0])
        else:
            operands = _tensors(args[0])
        b = sum(_nbytes(t) for t in operands)
        pg = next((a for a in args if isinstance(a, torch.ScriptObject)
                   and "ProcessGroup" in str(a._type())), None)
        link = self._link(pg)
        self.m[f"coll_bytes/{kind}"] += b
        self.m["coll_bytes_total"] += b
        self.m[f"coll_bytes/{link}"] += b

    def _link(self, pg) -> str:
        """"nvlink" when every rank of the group lies in one node of
        ``NODE_SIZE`` consecutive ranks, else "network"."""
        if pg is None:
            return "network"
        key = id(pg)
        if key not in self._groups:
            try:
                ranks = dist.get_process_group_ranks(
                    dist.ProcessGroup.unbox(pg))
            except (RuntimeError, ValueError):
                ranks = list(range(dist.get_world_size()))
            nodes = {r // NODE_SIZE for r in ranks}
            self._groups[key] = "nvlink" if len(nodes) == 1 else "network"
        return self._groups[key]

    # -- the result --------------------------------------------------------------
    def metrics(self) -> dict:
        """The counted keys (module docstring)."""
        self._rescan()
        out = {k: v for k, v in sorted(self.m.items())}
        out.setdefault("dot_flops", 0.0)
        out.setdefault("hbm_bytes", 0.0)
        out.setdefault("coll_bytes_total", 0.0)
        out["kernels"] = dict(sorted(self.kernels.items()))
        out["host_reads"] = self.host_reads
        if self.branches:
            out["branches"] = [f"{b['site'][0]}:{b['site'][1]}: {b['took']}"
                               for b in self.branches]
        return out

    def memory(self) -> dict:
        """The reference's ``memory_analysis`` keys (module docstring)."""
        return {"argument_size_in_bytes": int(self._arg_bytes),
                "output_size_in_bytes": int(self._out_bytes),
                "temp_size_in_bytes": int(self._peak)}


def count(fn, *args) -> tuple:
    """(output, metrics, memory) of one call ``fn(*args)`` counted by an
    :class:`OpAnalysis`."""
    oa = OpAnalysis()
    oa.arguments(args)
    with oa:
        out = fn(*args)
    oa.finish(out)
    return out, oa.metrics(), oa.memory()

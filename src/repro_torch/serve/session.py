"""Session: the serving protocol (port of ``repro.serve.session``), and
its two implementations:

  * ``RecsysSession`` — batched user ids -> top-k items over (possibly
    compressed) LightGCN tables, with capacity padding and hot swap;
  * ``ArchSession`` — the recsys architectures' serve and retrieval
    cells (``launch.steps.build_cell``): DLRM, Wide&Deep, SASRec and
    BERT4Rec, at smoke width or at the full published width on the card.

The protocol is the reference's: ``warmup(batch)``, ``__call__(ids)``,
``stats()``. Params and statics live on the session's device for its
lifetime. Each request recomputes the propagation from the codebooks
(E0 = Σ_h Z[sketch[i, h]] through the codebook_lookup kernel on CUDA),
then reads out the top-k:

  * "dense": scores every item (``u @ V.T``) and takes the top-k with
    ``lax.top_k``'s order;
  * "fused": the fused_topk kernel; the [B, n_items] score matrix never
    exists.

An int8 params dict dequantizes on the device before the propagation.
PyTorch runs eagerly, so there are no compiled programs to count; front
the session with ``BatchDispatcher`` to serve any batch size from a
fixed ladder of shapes.

Streaming deployments open the session with ``capacity``: params and
statics are padded up to power-of-two capacity rungs
(``capacity_plan``), and ``swap(artifact)`` copies a new artifact's
state INTO the session's device tensors. A swap whose sizes fit the
rungs allocates no device state (``state_allocations`` stays put, every
tensor keeps its ``data_ptr()``); one that outgrows a rung re-plans the
ladder, allocates, and counts a capacity bump.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import pad_rung as _cap_rung
from repro_torch.device import resolve_device
from repro_torch.embedding import (dequantize_params, fused_topk,
                                   normalize_backend, params_quantized)
from repro_torch.kernels.ref import topk_total_order
from repro_torch.models import lightgcn as L
from repro_torch.obs import LatencyRecorder, clock
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.telemetry import StreamTelemetry

__all__ = ["Session", "RecsysSession", "ArchSession", "DeviceState",
           "capacity_plan", "pad_to_capacity", "normalize_scorer"]

_SCORER_CHOICES = ("dense", "fused")


def normalize_scorer(name: Optional[str]) -> str:
    """None/"auto" -> "dense"; "fused" -> the one-pass fused_topk kernel."""
    if name in (None, "auto"):
        return "dense"
    name = str(name)
    if name not in _SCORER_CHOICES:
        raise ValueError(f"unknown scorer {name!r}; expected "
                         f"{'|'.join(_SCORER_CHOICES)} (or auto)")
    return name


# ---------------------------------------------------------------------------
# capacity ladder: pad the state so hot swaps keep every tensor's shape
# ---------------------------------------------------------------------------
_CAP_KEYS = ("n_users", "n_items", "k_users", "k_items", "n_edges")


def capacity_plan(mcfg, statics, **maxima) -> dict:
    """Capacity rungs covering the given state plus caller headroom.

    ``maxima`` may name any of n_users/n_items/k_users/k_items/n_edges
    with the largest value the deployment expects (e.g. the end of a
    replay stream); each capacity is the ladder rung (``pad_rung``)
    covering max(current, requested).
    """
    need = {"n_users": mcfg.n_users, "n_items": mcfg.n_items,
            "k_users": mcfg.k_users or 0, "k_items": mcfg.k_items or 0,
            "n_edges": int(statics["edge_u"].shape[0])}
    unknown = set(maxima) - set(_CAP_KEYS)
    if unknown:
        raise ValueError(f"unknown capacity keys {sorted(unknown)}; "
                         f"expected {_CAP_KEYS}")
    return {key: _cap_rung(max(need[key], int(maxima.get(key) or 0)))
            for key in _CAP_KEYS}


def _pad_rows(a, rows: int, fill=0):
    """``a`` (host numpy) padded to ``rows`` rows of ``fill``, in its own
    dtype; raises ValueError if it already has more."""
    a = np.asarray(a)
    if a.shape[0] > rows:
        raise ValueError(f"state of {a.shape[0]} rows exceeds capacity "
                         f"{rows}")
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _pad_state(params, statics, mcfg, caps: dict):
    """Pad (params, statics, mcfg) up to the capacity rungs; host numpy
    in and out.

    Piece by piece:
      * pad codebook/table rows are zero and unreferenced; int8 payloads
        (``{name}_q`` rows, ``{name}_scale`` vectors) ride the same rungs
        by table-name prefix;
      * pad sketch rows point at codebook row 0; only a caller asking
        for an id beyond the true count would read them;
      * pad edges (ids ``cu - 1`` / ``cv - 1``, norm 0) follow the real
        sorted runs, and lie OUTSIDE every CSR segment: both indptrs
        stay at ``e`` from the last real row to the end. The reference
        hangs them on the last capacity user and item (``indptr[-1] =
        ce``), where they add exactly 0; the port's CSR gather-sum folds
        a long row serially in one block, so one row of ``ce - e`` pad
        edges would cost more than the rest of the propagation. No
        consumer reads the edge arrays beyond ``indptr[-1]``: the
        propagation reads each row's segment only, and the tuner's
        sampler draws from the real graph. Real rows are bitwise
        unchanged; pad rows propagate to exactly 0;
      * ``edge_v_idx32`` / ``edge_u_byitem_idx32``, the int32 ids the
        propagation kernel reads, are made anew from the padded edges
        (``lightgcn.kernel_edge_ids``), so an in-place swap updates them
        with the rest of the state;
      * ``item_mask`` holds -inf for item slots beyond the true count:
        scores see ``+ mask``, so pad items never enter a top-k.
    """
    nu, nv = mcfg.n_users, mcfg.n_items
    cu, cv, ce = caps["n_users"], caps["n_items"], caps["n_edges"]
    p = {k: np.asarray(v) for k, v in params.items()}
    s = {k: np.asarray(v) for k, v in statics.items()}
    compressed = mcfg.k_users is not None
    u_rows = caps["k_users"] if compressed else cu
    v_rows = caps["k_items"] if compressed else cv
    out_p = {}
    for key, arr in p.items():
        if key.startswith("user_table"):
            out_p[key] = _pad_rows(arr, u_rows)
        elif key.startswith("item_table"):
            out_p[key] = _pad_rows(arr, v_rows)
        else:
            raise ValueError(f"unknown param table {key!r}")
    e = int(s["edge_u"].shape[0])
    out_s = {
        "edge_u": _pad_rows(s["edge_u"], ce, cu - 1),
        "edge_v": _pad_rows(s["edge_v"], ce, cv - 1),
        "edge_norm": _pad_rows(s["edge_norm"], ce, 0),
        "edge_u_byitem": _pad_rows(s["edge_u_byitem"], ce, cu - 1),
        "edge_norm_byitem": _pad_rows(s["edge_norm_byitem"], ce, 0),
    }
    for name, n_real, cap in (("indptr_u", nu, cu), ("indptr_v", nv, cv)):
        if cap < n_real:
            raise ValueError(f"{n_real} rows exceed capacity {cap}")
        ip = np.full(cap + 1, e, dtype=s[name].dtype)
        ip[:n_real + 1] = s[name]         # pad rows: empty segments
        out_s[name] = ip
    out_s.update(L.kernel_edge_ids(out_s["edge_v"], out_s["edge_u_byitem"]))
    if "sketch_u" in s:
        out_s["sketch_u"] = _pad_rows(s["sketch_u"], cu)
        out_s["sketch_v"] = _pad_rows(s["sketch_v"], cv)
    mask = np.zeros(cv, np.float32)
    mask[nv:] = -np.inf
    out_s["item_mask"] = mask
    mcfg2 = dataclasses.replace(
        mcfg, n_users=cu, n_items=cv,
        k_users=caps["k_users"] if compressed else None,
        k_items=caps["k_items"] if compressed else None)
    return out_p, out_s, mcfg2


def pad_to_capacity(params, statics, mcfg, caps: dict):
    """``_pad_state`` at ``caps``; state that outgrows a rung re-plans
    the ladder (``capacity_plan`` over it, ``caps`` as the maxima) and
    pads again. Returns (params, statics, mcfg, caps, bumped)."""
    try:
        return (*_pad_state(params, statics, mcfg, caps), caps, False)
    except ValueError:
        caps = capacity_plan(mcfg, statics, **caps)
        return (*_pad_state(params, statics, mcfg, caps), caps, True)


class DeviceState:
    """Named device tensors that host arrays are installed into in place.

    ``fill`` copies each host array into the tensor of the same name when
    its shape and dtype match, and allocates (and counts in
    ``allocations``) otherwise; names missing from the arrays are
    dropped. ``tensors`` is one dict for the object's life, so a holder
    of it sees every fill. On a CUDA device each array is staged in
    pinned host memory (one buffer per tensor, kept) and copied with
    ``copy_`` on the current stream, behind any work already enqueued
    there; the caller synchronizes before the next ``fill`` reuses the
    staging buffers."""

    def __init__(self, device, requires_grad: bool = False):
        self.device = device
        self.requires_grad = bool(requires_grad)
        self.tensors = {}
        self.allocations = 0
        self._staging = {}

    def fill(self, arrays: dict) -> int:
        """Install host ``arrays``; returns the tensors allocated."""
        allocated = 0
        for name in [k for k in self.tensors if k not in arrays]:
            del self.tensors[name]
            self._staging.pop(name, None)
        with torch.no_grad():
            for name, arr in arrays.items():
                src = torch.from_numpy(np.ascontiguousarray(arr))
                dst = self.tensors.get(name)
                if (dst is None or dst.shape != src.shape
                        or dst.dtype != src.dtype):
                    self.tensors[name] = src.to(self.device, copy=True) \
                        .requires_grad_(self.requires_grad)
                    self._staging.pop(name, None)
                    allocated += 1
                elif self.device.type != "cuda":
                    dst.copy_(src)
                else:
                    if name not in self._staging:
                        self._staging[name] = \
                            torch.empty_like(src).pin_memory()
                    self._staging[name].copy_(src)
                    dst.copy_(self._staging[name], non_blocking=True)
        self.allocations += allocated
        return allocated


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host_state(artifact):
    """(serving params, statics) of an artifact as host numpy."""
    statics = {k: v.numpy() for k, v in artifact.statics("cpu").items()}
    return ({k: np.asarray(v) for k, v in artifact.serving_params().items()},
            statics)


class Session:
    """Protocol base: ``warmup(batch)``, ``__call__(...)`` (one request,
    timed up to the device finishing it) and ``stats()``. PyTorch runs
    eagerly: there are no compiled programs, and ``compile_count`` is 0."""

    def warmup(self, batch: Optional[int] = None) -> None:
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError

    @property
    def compile_count(self) -> int:
        return 0


class RecsysSession(Session):
    """Top-k scoring over (possibly compressed) LightGCN tables.

    With ``capacity`` ("auto", True, or a dict of expected maxima) the
    state is padded to capacity rungs and ``swap`` copies new state into
    the same device tensors. ``state_allocations`` counts the params and
    statics tensors the session has allocated over its life.
    """

    def __init__(self, params, statics, mcfg, k: int = 20,
                 backend: Optional[str] = None, capacity=None,
                 telemetry: Optional[StreamTelemetry] = None,
                 scorer: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        if backend is not None:
            mcfg = dataclasses.replace(
                mcfg, lookup_backend=normalize_backend(backend))
        else:
            normalize_backend(mcfg.lookup_backend)   # validate early
        self.k = int(k)
        self.scorer = normalize_scorer(scorer)
        self._lat = LatencyRecorder()
        self._stream = telemetry or StreamTelemetry()
        self._caps = None
        self._state = (DeviceState(self.device), DeviceState(self.device))
        self.params, self.statics = (st.tensors for st in self._state)
        # publication identity: bumped on every swap; the content_id of
        # the served artifact when the session came from one
        self.swap_epoch = 0
        self.artifact_id = None
        params = {name: _host(a) for name, a in params.items()}
        statics = {name: _host(a) for name, a in statics.items()}
        if capacity is not None:
            if capacity is True or capacity == "auto":
                capacity = {}
            params, statics, mcfg, self._caps, _ = pad_to_capacity(
                params, statics, mcfg,
                capacity_plan(mcfg, statics, **capacity))
        self._install(params, statics, mcfg)

    @classmethod
    def from_artifact(cls, artifact, k: int = 20,
                      backend: Optional[str] = None, capacity=None,
                      telemetry: Optional[StreamTelemetry] = None,
                      scorer: Optional[str] = None,
                      device="cuda") -> "RecsysSession":
        """The deploy path: a session over a loaded CompressedArtifact
        (either package's). A quantized artifact serves its int8
        payload."""
        dev = resolve_device(device)
        params, statics = _host_state(artifact)
        session = cls(params, statics, artifact.mcfg(), k=k,
                      backend=backend, capacity=capacity,
                      telemetry=telemetry, scorer=scorer, device=dev)
        session.artifact_id = artifact.content_id()
        return session

    # -- device state --------------------------------------------------------
    @property
    def state_allocations(self) -> int:
        """Params and statics tensors allocated over the session's life."""
        return sum(st.allocations for st in self._state)

    def _install(self, params, statics, mcfg) -> int:
        """Put host (params, statics) into the session's device state and
        make ``mcfg`` current. Work is enqueued on the current stream, so
        a request enqueued before it reads the old state and one after
        it the new. Returns the number of tensors allocated."""
        allocated = (self._state[0].fill(params)
                     + self._state[1].fill(statics))
        self._sync()
        self.mcfg = mcfg
        return allocated

    # -- hot swap ------------------------------------------------------------
    def swap(self, artifact) -> dict:
        """Switch to a new artifact's state between requests.

        The only sanctioned way to change what a live session serves.
        Under a capacity ladder, a swap whose sizes fit the current rungs
        copies into the existing device tensors and allocates nothing; a
        swap that outgrows a rung re-plans the ladder, allocates, and
        counts a capacity bump. Call it from the thread that owns the
        session's CUDA stream: the copies are ordered on that stream, so
        a request enqueued before the swap reads the old state. Returns
        the swap's stats.
        """
        t0 = clock.now()
        with get_tracer().span("session_swap",
                               artifact=artifact.content_id()) as span:
            mcfg = dataclasses.replace(
                artifact.mcfg(), lookup_backend=self.mcfg.lookup_backend)
            params, statics = _host_state(artifact)
            bumped = False
            if self._caps is not None:
                params, statics, mcfg, self._caps, bumped = pad_to_capacity(
                    params, statics, mcfg, self._caps)
                if bumped:
                    self._stream.bump("capacity_bumps")
            allocated = self._install(params, statics, mcfg)
            self.swap_epoch += 1
            self.artifact_id = artifact.content_id()
            ms = clock.ms_between(t0, clock.now())
            span.set(ms=round(ms, 3), capacity_bumped=bumped,
                     allocated=allocated)
        self._stream.swap.record(ms)
        return {"ms": round(ms, 3), "capacity_bumped": bumped,
                "capacity": dict(self._caps) if self._caps else None,
                "state_allocations": allocated}

    @property
    def telemetry(self) -> StreamTelemetry:
        return self._stream

    def _score_topk(self, user_ids):
        params = dequantize_params(self.params)
        mask = self.statics.get("item_mask")
        if self.scorer == "fused":
            u, v = L.eval_embeddings(params, self.statics, self.mcfg,
                                     user_ids)
            return fused_topk(u, v, self.k, mask=mask)
        scores = L.score_all_items(params, self.statics, self.mcfg, user_ids)
        if mask is not None:
            scores = scores + mask[None, :]
        return topk_total_order(scores, self.k)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch: Optional[int] = None) -> None:
        """Run one request of ``batch`` rows, untimed."""
        ids = torch.zeros(int(batch or 1), dtype=torch.int64,
                          device=self.device)
        self._score_topk(ids)
        self._sync()

    def __call__(self, user_ids):
        """user_ids int [B] -> (values f32 [B,k], item_ids int32 [B,k]),
        tensors on the session's device; the latency recorded is the
        request's, up to the device finishing it."""
        ids = torch.as_tensor(np.asarray(user_ids), dtype=torch.int64,
                              device=self.device)
        t0 = clock.now()
        out = self._score_topk(ids)
        self._sync()
        self._lat.record(clock.ms_between(t0, clock.now()))
        return out

    def stats(self) -> dict:
        out = {"kind": "recsys", "k": self.k,
               "backend": self.mcfg.lookup_backend or "auto",
               "scorer": self.scorer, "device": str(self.device),
               "quantized": params_quantized(self.params),
               "state_allocations": self.state_allocations,
               **self._lat.summary()}
        if self._caps is not None or self._stream.swap.count:
            out["capacity"] = dict(self._caps) if self._caps else None
            out["stream"] = self._stream.summary()
        return out


class ArchSession(Session):
    """Serve, retrieval, prefill and decode cells of the architectures
    (``launch.steps.build_cell``): smoke width by default, the full
    published width with ``smoke=False`` on the card (dlrm-mlperf-baco's
    24.1 GB of tables; the LMs at one card's cuts, ``cuts`` such as
    ``batch=4``, see ``steps.LM_ONE_CARD``).

    Each request runs the cell's step on its arguments, which stay on the
    device for the session's life. A decode cell returns (logits, cache)
    and its cache goes on to the next request through ``Cell.next_args``:
    the step updates it in place, the port's counterpart of the
    reference's donated buffer (``donates_cache`` is True).
    """

    def __init__(self, arch_id: str, shape: str = "serve_p99",
                 backend: Optional[str] = None, smoke: bool = True,
                 device="cuda", **cuts):
        from repro_torch.launch.steps import build_cell
        self.device = resolve_device(device)
        self.cell = build_cell(arch_id, shape, smoke=smoke,
                               lookup_backend=normalize_backend(backend),
                               device=self.device, **cuts)
        self._args = self.cell.args
        self._lat = LatencyRecorder()
        self._warm = False

    @property
    def donates_cache(self) -> bool:
        return self.cell.kind == "decode" and bool(self.cell.donate)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self, batch: Optional[int] = None) -> None:
        """Run one request, untimed."""
        out = self.cell.fn(*self._args)
        self._sync()
        self._args = self.cell.next_args(self._args, out)
        self._warm = True

    def __call__(self):
        """One request on the cell's arguments; the latency recorded is
        the request's, up to the device finishing it."""
        if not self._warm:
            self.warmup()
        self._sync()
        t0 = clock.now()
        out = self.cell.fn(*self._args)
        self._sync()
        self._lat.record(clock.ms_between(t0, clock.now()))
        self._args = self.cell.next_args(self._args, out)
        return out

    def tokens_per_request(self) -> Optional[int]:
        """Tokens a prefill (B x S) or decode (B) request processes."""
        if self.cell.kind not in ("prefill", "decode"):
            return None
        return int(self.cell.args[-1]["tokens"].numel())

    def stats(self) -> dict:
        out = {"kind": self.cell.kind, "arch": self.cell.arch_id,
               "shape": self.cell.shape_name,
               "cache_donated": self.donates_cache,
               "compiles": self.compile_count, **self._lat.summary()}
        tokens = self.tokens_per_request()
        if tokens is not None and self._lat.count:
            out["tokens_per_request"] = tokens
            out["tokens_per_s"] = tokens / (self._lat.percentile(50) / 1e3)
        if self.cell.reduced:
            out["reduced"] = list(self.cell.reduced)
        return out

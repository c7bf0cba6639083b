"""Spans and trace IDs (the part of ``repro.obs.trace`` the port uses).

``get_tracer().span(name, **attrs)`` is a context-managed child of the
current thread's ambient span, or a fresh root when there is none.
Sampling is decided once per trace at root creation and inherited by
every child. A disabled tracer (the default) returns the shared
:data:`NULL_SPAN` from every call: no allocation, no clock read, no lock.

The reference bridges live spans into ``jax.profiler`` annotations; the
port has no such bridge yet (a ``torch.profiler.record_function``
bridge would take its place).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .clock import now

__all__ = ["Span", "Tracer", "NULL_SPAN", "get_tracer", "configure"]


class _NullSpan:
    """The do-nothing span a disabled (or down-sampled) tracer returns."""

    __slots__ = ()
    sampled = False
    trace_id = ""
    span_id = ""
    name = ""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **attrs):
        return self

    def set(self, **attrs):
        return self

    def __bool__(self):
        return False

    def __repr__(self):
        return "NULL_SPAN"


NULL_SPAN = _NullSpan()


class Span:
    """One timed, named, attributed section of work inside a trace."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "t_start", "t_end", "attrs", "thread", "sampled")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str, name: str, t_start: float,
                 attrs: Optional[dict] = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end = float("nan")
        self.attrs: Dict[str, object] = dict(attrs) if attrs else {}
        self.thread = threading.current_thread().name
        self.sampled = True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer._pop(self)
        self.end()
        return False

    def end(self, **attrs) -> "Span":
        """Close the span at ``clock.now()`` and commit it (idempotent)."""
        if attrs:
            self.attrs.update(attrs)
        if self.t_end == self.t_end:      # already closed (not NaN)
            return self
        self.t_end = now()
        self.tracer._commit(self)
        return self


class Tracer:
    """Creates, nests, samples, and collects spans in bounded memory.

    ``sample_rate`` is the fraction of traces kept (deterministic
    error-diffusion head sampling); ``max_spans`` caps the committed
    buffer, and overflow increments :attr:`dropped` instead of growing.
    """

    def __init__(self, enabled: bool = True, sample_rate: float = 1.0,
                 max_spans: int = 100_000):
        self.enabled = bool(enabled)
        self.sample_rate = float(sample_rate)
        self.max_spans = int(max_spans)
        self.dropped = 0
        self._spans: List[Span] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._n_traces = 0
        self._n_spans = 0
        self._sample_acc = 0.0

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:                  # mis-nested exit: drop through
            st.remove(span)

    def current(self) -> Optional[Span]:
        """The innermost live span on this thread, if any."""
        st = self._stack()
        return st[-1] if st else None

    def _ids(self, new_trace: bool):
        with self._lock:
            if new_trace:
                self._n_traces += 1
                sampled = False
                if self.sample_rate > 0:
                    self._sample_acc += min(self.sample_rate, 1.0)
                    if self._sample_acc >= 1.0 - 1e-12:
                        self._sample_acc -= 1.0
                        sampled = True
                trace_id = f"t{self._n_traces:06d}"
            else:
                trace_id, sampled = "", True
            self._n_spans += 1
            return trace_id, f"s{self._n_spans:06d}", sampled

    def trace(self, name: str, **attrs):
        """Open a new root span / new trace."""
        if not self.enabled:
            return NULL_SPAN
        trace_id, span_id, sampled = self._ids(new_trace=True)
        if not sampled:
            return NULL_SPAN
        return Span(self, trace_id, span_id, "", name, now(), attrs)

    def span(self, name: str, parent: Optional[Span] = None, **attrs):
        """A child of ``parent`` (default: this thread's ambient span;
        a fresh root if there is none). Use as a context manager."""
        if not self.enabled:
            return NULL_SPAN
        if parent is None:
            parent = self.current()
        if parent is None:
            return self.trace(name, **attrs)
        if not getattr(parent, "sampled", False):
            return NULL_SPAN
        _, span_id, _ = self._ids(new_trace=False)
        return Span(self, parent.trace_id, span_id, parent.span_id,
                    name, now(), attrs)

    def _commit(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) >= self.max_spans:
                self.dropped += 1
            else:
                self._spans.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> List[Span]:
        """Return and clear the committed spans."""
        with self._lock:
            out, self._spans = self._spans, []
            return out


# Disabled by default; configure() mutates THIS object in place, so
# modules that grabbed get_tracer() at import time see the change.
_GLOBAL = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-wide ambient tracer (disabled until configured)."""
    return _GLOBAL


def configure(enabled: bool = True, sample_rate: Optional[float] = None,
              max_spans: Optional[int] = None) -> Tracer:
    """Reconfigure the global tracer in place and return it."""
    t = _GLOBAL
    t.enabled = bool(enabled)
    if sample_rate is not None:
        t.sample_rate = float(sample_rate)
    if max_spans is not None:
        t.max_spans = int(max_spans)
    return t

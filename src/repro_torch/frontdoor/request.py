"""Request/response plumbing for the async front end (port of
``repro.frontdoor.request``).

A submitted request becomes a ``Request`` (the queue entry) holding a
``Ticket`` (the caller's future). The batcher resolves or rejects the
ticket; ``Ticket.result()`` blocks the caller until then. Rejections are
typed so load generators and callers can tell admission sheds (the
server refused to queue) from deadline timeouts (queued but expired
before it was worth scoring) — the two backpressure outcomes a
production front end must account for separately.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np

from repro_torch.obs import clock

__all__ = ["Ticket", "Request", "RequestShed", "DeadlineExceeded"]


class RequestShed(RuntimeError):
    """Admission control refused the request (bounded queue full under
    the "shed" policy). Cheap by design: no device work was done."""


class DeadlineExceeded(TimeoutError):
    """The request expired in the queue before scoring. Rejected at
    flush time without touching the device — a timed-out caller is
    gone, so scoring for it would only steal capacity from live ones."""


class Ticket:
    """One-shot future for a single request's (values, items) response.

    ``t_done`` is the obs clock reading at which it was resolved or
    rejected (None while pending): load generators use it to place a
    response before or after a mid-load swap."""

    __slots__ = ("_event", "_value", "_error", "t_done")

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._error: Optional[BaseException] = None
        self.t_done: Optional[float] = None

    def done(self) -> bool:
        return self._event.is_set()

    def resolve(self, value: Tuple[np.ndarray, np.ndarray]) -> None:
        self._value = value
        self.t_done = clock.now()
        self._event.set()

    def reject(self, error: BaseException) -> None:
        self._error = error
        self.t_done = clock.now()
        self._event.set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Block until resolved; returns (values [n, k], items [n, k])
        host arrays, or raises the rejection error."""
        if not self._event.wait(timeout):
            raise TimeoutError("ticket not resolved within timeout "
                               "(is the Frontdoor started?)")
        if self._error is not None:
            raise self._error
        return self._value

    def error(self) -> Optional[BaseException]:
        """The rejection error, if any (None while pending/resolved)."""
        return self._error


@dataclasses.dataclass
class Request:
    """One queued scoring request.

    user_ids:  int32 [n] — the identity the response rows map back to
    tenant:    logical session name (resolved to a device session at
               FLUSH time, so requests queued across a swap serve the
               newly published version; in-flight batches keep the old)
    ticket:    the caller's future
    t_submit:  obs clock reading at admission (queue-delay / e2e clock)
    deadline:  absolute obs-clock budget, or None
    span:      the request's root trace span (opened on the caller
               thread at submit, closed on the batcher thread; the obs
               NULL_SPAN when tracing is off or the trace unsampled)
    """

    user_ids: np.ndarray
    tenant: str
    ticket: Ticket
    t_submit: float
    deadline: Optional[float] = None
    span: Optional[object] = None

    @property
    def n(self) -> int:
        return int(self.user_ids.shape[0])

    def expired(self, now: Optional[float] = None) -> bool:
        if self.deadline is None:
            return False
        return (now if now is not None else clock.now()) > self.deadline

"""Serving primitives: requests, tickets, per-tenant results, and errors
(port of ``serving/session.py``).

The reference's serving story was a long-lived Spark driver holding a
``TimeSeriesRDD`` across many actions; callers handed it work and got
futures back.  The resident :class:`~.server.FitServer` needs the same
vocabulary, host-side and zero-dep:

- :class:`FitRequest` — one tenant's admitted panel fit (rows, model,
  kwargs, deadline, priority), with a durable npz spelling
  (:meth:`FitRequest.save` / :meth:`FitRequest.load`) so a SIGKILLed
  server can re-answer it on restart.
- :class:`FitTicket` — the caller's handle: a small future resolved by
  the serve loop (``result(timeout=)`` blocks, ``cancel()`` withdraws a
  queued request, a shed request resolves to :class:`RejectedError`).
- :class:`TenantFitResult` — the demuxed slice of a micro-batched walk:
  the same field layout as ``reliability.ResilientFitResult``, rows
  aligned with the request's panel.
- The error vocabulary: :class:`RejectedError` (admission control said
  no — carries ``retry_after_s``, the serving layer's backpressure
  signal; never an OOM), :class:`CancelledError`,
  :class:`ServerClosedError`.

Nothing here touches a device: requests carry host ``np.ndarray`` panels
(a tensor submitted on the card is copied to the host for the write-ahead
record, and the batch walk reads the rows back onto the server's device)
and results carry host arrays, exactly like the chunk walk's output.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, NamedTuple, Optional, Union

import numpy as np

from ..reliability.journal import consult_disk_fault, tear_after_replace

__all__ = [
    "CancelledError",
    "FitRequest",
    "FitTicket",
    "RejectedError",
    "ServerClosedError",
    "StorageError",
    "TenantFitResult",
]


class RejectedError(RuntimeError):
    """Admission control refused (or shed) a request.

    ``retry_after_s`` is the server's backpressure estimate — how long
    until the queue has likely drained enough to admit this work; clients
    should back off at least that long.  ``shed=True`` means the request
    WAS admitted and later evicted to make room for higher-priority work
    (overload shedding); ``shed=False`` means it was refused at the door.
    Raised instead of queueing unboundedly: the server's memory ceiling is
    enforced here, so overload degrades to explicit rejections, never to
    an OOM.
    """

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 shed: bool = False):
        super().__init__(
            f"fit request rejected ({reason}); retry after "
            f"{retry_after_s:.2f}s")
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.shed = bool(shed)


class StorageError(RejectedError):
    """The server's durable root refused a write (EIO / ENOSPC / a torn
    fsync) so the request cannot be admitted SAFELY — an admission whose
    write-ahead record did not land would be lost by the next crash,
    which would break the re-answer contract.  Subclasses
    :class:`RejectedError` so every quota-release / backpressure path
    treats it as a refusal at the door; the wire serializes it as its
    own ``storage_degraded`` kind so clients know to prefer OTHER
    replicas rather than merely waiting out a queue."""

    def __init__(self, reason: str, retry_after_s: float = 5.0):
        super().__init__(f"storage degraded: {reason}",
                         retry_after_s=retry_after_s, shed=False)
        self.reason = reason


class CancelledError(RuntimeError):
    """The caller withdrew the request before it produced a result."""


class ServerClosedError(RuntimeError):
    """The server is draining, stopped, or crashed; resubmit elsewhere (a
    crashed server's admitted requests are durable — a restart on the same
    root re-answers them)."""


class TenantFitResult(NamedTuple):
    """One request's demuxed fit output (host arrays, rows aligned with
    the request's panel) — the per-tenant slice of
    ``reliability.ResilientFitResult``."""

    params: np.ndarray  # [rows, k]
    neg_log_likelihood: np.ndarray  # [rows]
    converged: np.ndarray  # [rows] bool
    iters: np.ndarray  # [rows]
    status: np.ndarray  # [rows] int8 FitStatus codes
    meta: dict


class FitRequest:
    """One admitted fit request: a tenant's ``[rows, T]`` panel plus the
    fit configuration.  Instances are created by ``FitServer.submit`` and
    by restart recovery (:meth:`load`)."""

    __slots__ = ("req_id", "seq", "tenant", "values", "model", "fit_kwargs",
                 "priority", "deadline_s", "admitted_at", "align_mode",
                 "resilient", "policy", "ticket")

    def __init__(self, req_id: str, seq: int, tenant: str,
                 values: np.ndarray, model: Union[str, Callable],
                 fit_kwargs: dict, *, priority: int = 0,
                 deadline_s: Optional[float] = None,
                 align_mode: str = "general", resilient: bool = False,
                 policy: str = "impute"):
        self.req_id = req_id
        self.seq = int(seq)
        self.tenant = str(tenant)
        self.values = values
        self.model = model
        # canonicalized through a JSON round trip at ADMISSION: the durable
        # request record is JSON, and the journal's config hash covers the
        # kwargs by repr — a live run fitting `order=(1,0,0)` while its
        # restarted twin fits `order=[1,0,0]` would hash as two different
        # configs and refuse to resume its own journal.  Non-JSON kwargs
        # (device arrays, callables) are refused loudly here: they could
        # not survive a restart either.
        try:
            self.fit_kwargs = json.loads(json.dumps(dict(fit_kwargs)))
        except (TypeError, ValueError) as e:
            raise TypeError(
                "serving fit kwargs must be JSON-serializable (they are "
                f"journaled for crash recovery): {e}") from None
        self.priority = int(priority)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.admitted_at = time.monotonic()
        self.align_mode = align_mode
        self.resilient = bool(resilient)
        self.policy = str(policy)
        self.ticket = FitTicket(req_id)

    @property
    def rows(self) -> int:
        return int(self.values.shape[0])

    def remaining_s(self) -> Optional[float]:
        """Seconds until this request's deadline; None when unbounded."""
        if self.deadline_s is None:
            return None
        return self.deadline_s - (time.monotonic() - self.admitted_at)

    def expired(self) -> bool:
        rem = self.remaining_s()
        return rem is not None and rem <= 0.0

    # -- durability ----------------------------------------------------------
    # One npz per request, written at admission BEFORE the caller's ticket
    # is returned: the request is the serving layer's write-ahead record
    # (the batch journals cover compute; this covers the QUEUE).  Model
    # callables are referenced by registry NAME so a restarted server can
    # re-resolve them — an unnamed callable is refused at submit.

    def save(self, path: str) -> None:
        # disk-fault seam: the write-ahead record is the admission
        # contract's durability — an injected EIO/ENOSPC raises HERE,
        # before the caller's ticket exists, so the server can refuse
        # admission with a typed StorageError instead of losing work
        verdict = consult_disk_fault(path, "write_ahead")
        meta = {
            "req_id": self.req_id, "seq": self.seq, "tenant": self.tenant,
            "model": self.model, "fit_kwargs": self.fit_kwargs,
            "priority": self.priority, "deadline_s": self.deadline_s,
            "align_mode": self.align_mode, "resilient": self.resilient,
            "policy": self.policy,
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, values=self.values,
                     meta=np.frombuffer(
                         json.dumps(meta).encode(), dtype=np.uint8))
        os.replace(tmp, path)
        if verdict == "torn":
            tear_after_replace(path)

    @classmethod
    def load(cls, path: str) -> "FitRequest":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"].tobytes()).decode())
            values = np.array(z["values"])
        req = cls(meta["req_id"], meta["seq"], meta["tenant"], values,
                  meta["model"], meta["fit_kwargs"],
                  priority=meta["priority"], deadline_s=meta["deadline_s"],
                  align_mode=meta["align_mode"], resilient=meta["resilient"],
                  policy=meta["policy"])
        return req


class FitTicket:
    """The caller's future for one request.

    Exactly one terminal transition ever lands (result, error, cancelled,
    shed); ``result(timeout=)`` blocks until it does.  Tickets are
    process-local — after a server crash the durable request is re-answered
    through ``FitServer.result_for`` on the restarted server, not through
    the dead process's ticket objects.
    """

    __slots__ = ("req_id", "_done", "_result", "_error", "_cancelled",
                 "_lock", "_canceller")

    # lock-discipline contract (tools/lint lock-map): the serve loop,
    # shedding offers on other caller threads, and cancel() all race to
    # land the ONE terminal transition; _lock arbitrates, _done.set()
    # is the (atomic) publication.
    _protected_by_ = {
        "_result": "_lock",
        "_error": "_lock",
        "_cancelled": "_lock",
    }

    def __init__(self, req_id: str):
        self.req_id = req_id
        self._done = threading.Event()
        self._result: Optional[TenantFitResult] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._lock = threading.Lock()
        self._canceller = None  # set by the server at admission

    # -- serve-loop side -----------------------------------------------------

    def _resolve(self, result: TenantFitResult) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._result = result
            self._done.set()

    def _reject(self, error: BaseException) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._error = error
            self._done.set()

    def _mark_cancelled(self) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._cancelled = True
            self._error = CancelledError(
                f"request {self.req_id} cancelled before completion")
            self._done.set()

    # -- caller side ---------------------------------------------------------

    def cancel(self) -> bool:
        """Withdraw the request.  Returns True when the cancellation took
        effect (the request was still queued — it will never dispatch and
        ``result()`` raises :class:`CancelledError`).  A request already
        IN a dispatched batch cannot be cancelled mid-walk (a kernel launch
        is not interruptible — the same contract as the watchdog's
        abandonment): the walk completes and the result is delivered;
        False is returned."""
        c = self._canceller
        if c is not None and c(self.req_id):
            self._mark_cancelled()
            return True
        return self._done.is_set() and self._cancelled

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def result(self, timeout: Optional[float] = None) -> TenantFitResult:
        """Block for the demuxed result (raises the terminal error for a
        shed/cancelled/failed request; ``TimeoutError`` if ``timeout``
        elapses first — the request itself stays in flight)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.req_id} still in flight after {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    def error(self) -> Optional[BaseException]:
        """The terminal error, if the ticket resolved to one (non-blocking)."""
        return self._error if self._done.is_set() else None

"""Admission control: bounded queue, per-tenant quotas, overload shedding
(port of ``serving/admission.py``).

Spark's scheduler admitted unbounded work and let executors die of it; a
resident serving process cannot.  This module is the server's front door
and enforces three invariants:

1. **Bounded memory**: the queue holds at most ``max_queue_rows`` panel
   rows / ``max_queue_requests`` requests.  Past the bound a new request
   is REJECTED with :class:`~.session.RejectedError` carrying a
   ``retry_after_s`` backpressure estimate (queued rows over the recent
   drain rate) — overload is an explicit signal, never an allocator
   failure.
2. **Priority shedding**: when the queue is full and a HIGHER-priority
   request arrives, the lowest-priority queued work is shed (its ticket
   resolves to ``RejectedError(shed=True)``) until the newcomer fits —
   the degradation ladder drops the least important work first, loudly.
3. **Per-tenant quotas** (:class:`TenantQuota`): one tenant cannot starve
   the rest — at most ``max_inflight_per_tenant`` requests /
   ``max_rows_per_tenant`` rows admitted-but-unanswered per tenant, and
   ``max_rows_per_request`` bounds any single panel.

Everything is host-side and lock-protected; the serve loop is the single
consumer, caller threads are concurrent producers.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

from .session import FitRequest, RejectedError

__all__ = ["AdmissionQueue", "TenantQuota"]


class TenantQuota:
    """Per-tenant in-flight budget (requests + rows, admission to answer)."""

    # lock-discipline contract (tools/lint lock-map): caller threads
    # acquire, the serve loop releases — the ledger mutates under _lock.
    _protected_by_ = {"_inflight": "_lock"}

    def __init__(self, max_inflight_per_tenant: Optional[int] = None,
                 max_rows_per_tenant: Optional[int] = None,
                 max_rows_per_request: Optional[int] = None):
        self.max_inflight = max_inflight_per_tenant
        self.max_rows = max_rows_per_tenant
        self.max_rows_per_request = max_rows_per_request
        self._lock = threading.Lock()
        self._inflight: dict = {}  # tenant -> [n_requests, n_rows]

    def try_acquire(self, tenant: str, rows: int,
                    force: bool = False) -> None:
        """Admit ``rows`` for ``tenant`` or raise :class:`RejectedError`.

        ``force=True`` records the acquisition even past the limits
        (restart recovery re-admits work the dead server already
        accepted; quotas may transiently overcommit, but the
        acquire/release ledger stays symmetric so steady-state
        accounting is exact)."""
        if (not force and self.max_rows_per_request is not None
                and rows > self.max_rows_per_request):
            raise RejectedError(
                f"request of {rows} rows exceeds the per-request cap "
                f"{self.max_rows_per_request}", retry_after_s=0.0)
        with self._lock:
            n, r = self._inflight.get(tenant, (0, 0))
            if not force:
                if self.max_inflight is not None and n >= self.max_inflight:
                    raise RejectedError(
                        f"tenant {tenant!r} already has {n} requests in "
                        f"flight (quota {self.max_inflight})",
                        retry_after_s=0.5)
                if self.max_rows is not None and r + rows > self.max_rows:
                    raise RejectedError(
                        f"tenant {tenant!r} would hold {r + rows} rows in "
                        f"flight (quota {self.max_rows})", retry_after_s=0.5)
            self._inflight[tenant] = (n + 1, r + rows)

    def release(self, tenant: str, rows: int) -> None:
        with self._lock:
            n, r = self._inflight.get(tenant, (0, 0))
            n, r = max(0, n - 1), max(0, r - rows)
            if n == 0 and r == 0:
                self._inflight.pop(tenant, None)
            else:
                self._inflight[tenant] = (n, r)

    def snapshot(self) -> dict:
        with self._lock:
            return {t: {"requests": n, "rows": r}
                    for t, (n, r) in sorted(self._inflight.items())}


class AdmissionQueue:
    """Bounded FIFO of admitted requests with priority-aware shedding.

    Producers call :meth:`offer`; the serve loop calls
    :meth:`take_batch`.  FIFO order is by admission sequence so batching
    is fair; priorities only matter under overload (who gets shed).
    """

    # lock-discipline contract (tools/lint lock-map): producers offer
    # from caller threads, the serve loop consumes; ``_not_empty`` is a
    # Condition BUILT ON ``_lock``, so either spelling holds the same
    # lock — both are declared as acceptable guards.
    _protected_by_ = {
        "_q": ("_lock", "_not_empty"),
        "_rows": ("_lock", "_not_empty"),
        "shed_total": ("_lock", "_not_empty"),
        "rejected_total": ("_lock", "_not_empty"),
        "admitted_total": ("_lock", "_not_empty"),
        "last_refusal_at": ("_lock", "_not_empty"),
        "_drain_rows_per_s": ("_lock", "_not_empty"),
        "_closed": ("_lock", "_not_empty"),
    }

    def __init__(self, max_queue_rows: int = 65_536,
                 max_queue_requests: int = 1024):
        self.max_queue_rows = int(max_queue_rows)
        self.max_queue_requests = int(max_queue_requests)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._q: List[FitRequest] = []
        self._rows = 0
        self.shed_total = 0
        self.rejected_total = 0
        self.admitted_total = 0
        self.last_refusal_at: Optional[float] = None
        # drain-rate EMA (rows/s) feeding the retry_after estimate; seeded
        # pessimistically so a cold server does not promise instant retries
        self._drain_rows_per_s = 1000.0
        self._closed = False

    # -- producer side -------------------------------------------------------

    def offer(self, req: FitRequest,
              on_shed: Optional[Callable] = None) -> None:
        """Enqueue ``req`` or raise :class:`RejectedError`.

        A full queue first tries to shed strictly-lower-priority queued
        requests (lowest priority first, newest first within a priority —
        the work least likely to matter and least far along).  Shed
        requests' tickets are rejected with ``shed=True`` and ``on_shed``
        is called for each (the server refunds quotas/durable state
        there).  If shedding cannot make room, the OFFER is rejected.
        """
        if req.rows > self.max_queue_rows:
            # no amount of shedding admits a panel bigger than the queue —
            # refuse before evicting anyone for nothing
            raise RejectedError(
                f"request of {req.rows} rows exceeds the queue bound "
                f"{self.max_queue_rows}", retry_after_s=0.0)
        with self._lock:
            if self._closed:
                raise RejectedError("server is draining", retry_after_s=5.0)
            shed: List[FitRequest] = []
            while self._over_capacity(req.rows - sum(s.rows for s in shed),
                                      1 - len(shed)):
                victim = self._shed_candidate(req.priority, exclude=shed)
                if victim is None:
                    self.rejected_total += 1
                    self.last_refusal_at = time.monotonic()
                    raise RejectedError(
                        f"queue full ({self._rows} rows / {len(self._q)} "
                        "requests queued)",
                        retry_after_s=self._retry_after(req.rows))
                shed.append(victim)
            for victim in shed:
                self._q.remove(victim)
                self._rows -= victim.rows
                self.shed_total += 1
                self.last_refusal_at = time.monotonic()
                victim.ticket._reject(RejectedError(
                    f"shed for priority-{req.priority} work",
                    retry_after_s=self._retry_after(victim.rows),
                    shed=True))
                if on_shed is not None:
                    on_shed(victim)
            self._q.append(req)
            self._rows += req.rows
            self.admitted_total += 1
            self._not_empty.notify()

    def _over_capacity(self, extra_rows: int, extra_reqs: int) -> bool:
        return (self._rows + extra_rows > self.max_queue_rows
                or len(self._q) + extra_reqs > self.max_queue_requests)

    def _shed_candidate(self, priority: int,
                        exclude: List[FitRequest]) -> Optional[FitRequest]:
        victims = [r for r in self._q
                   if r.priority < priority and r not in exclude]
        if not victims:
            return None
        return min(victims, key=lambda r: (r.priority, -r.seq))

    def _retry_after(self, rows: int) -> float:
        backlog = self._rows + rows
        est = backlog / max(self._drain_rows_per_s, 1e-6)
        return min(60.0, max(0.05, est))

    def cancel(self, req_id: str) -> Optional[FitRequest]:
        """Remove a queued request (caller cancellation); None if it is
        not in the queue (already dispatched, answered, or shed)."""
        with self._lock:
            for r in self._q:
                if r.req_id == req_id:
                    self._q.remove(r)
                    self._rows -= r.rows
                    return r
        return None

    # -- consumer side -------------------------------------------------------

    def take_batch(self, key_fn: Callable, max_rows: int,
                   window_s: float = 0.01,
                   timeout_s: Optional[float] = 0.25,
                   rows_fn: Optional[Callable] = None) -> List[FitRequest]:
        """Pop the next micro-batch: wait up to ``timeout_s`` for a first
        request, linger ``window_s`` for company to coalesce with, then
        greedily collect FIFO requests sharing the first one's batch key
        up to ``max_rows``.  ``rows_fn`` overrides how a request's rows
        count against the cap (the server passes the CELL-PADDED size so
        the packed panel, not just the payload, honors
        ``max_batch_rows``).  Returns ``[]`` on timeout (the serve
        loop's idle tick)."""
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._not_empty:
            while not self._q:
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return []
                if not self._not_empty.wait(timeout=rem):
                    return []
        if window_s > 0:
            # linger OUTSIDE the lock: producers must be able to add the
            # company this window exists to collect
            time.sleep(window_s)
        cost = rows_fn if rows_fn is not None else (lambda r: r.rows)
        with self._lock:
            if not self._q:
                return []
            head = self._q[0]
            key = key_fn(head)
            batch, rows = [], 0
            for r in list(self._q):
                if rows + cost(r) > max_rows and batch:
                    break
                if key_fn(r) == key:
                    batch.append(r)
                    rows += cost(r)
                    if rows >= max_rows:
                        break
            for r in batch:
                self._q.remove(r)
                self._rows -= r.rows
            return batch

    def record_drain(self, rows: int, wall_s: float) -> None:
        """Feed the drain-rate EMA after a batch completes (the
        retry_after backpressure estimate)."""
        if wall_s <= 0 or rows <= 0:
            return
        rate = rows / wall_s
        with self._lock:
            self._drain_rows_per_s = (0.7 * self._drain_rows_per_s
                                      + 0.3 * rate)

    # -- lifecycle / introspection -------------------------------------------

    def close(self) -> List[FitRequest]:
        """Refuse new offers; return (and clear) whatever is still queued."""
        with self._lock:
            self._closed = True
            drained, self._q = self._q, []
            self._rows = 0
            self._not_empty.notify_all()
            return drained

    def depth(self) -> dict:
        with self._lock:
            return {"requests": len(self._q), "rows": self._rows,
                    "max_rows": self.max_queue_rows,
                    "max_requests": self.max_queue_requests,
                    "admitted_total": self.admitted_total,
                    "shed_total": self.shed_total,
                    "rejected_total": self.rejected_total}

"""Deadline watchdog: wall-clock budgets for fit dispatch (port of
``reliability/watchdog.py``).

Spark bounded a runaway job twice over — ``spark.task.maxFailures`` killed a
task that would not finish, and the driver's scheduler could abandon a stage
that blew its allotment.  Here a fit is one batched call over many rows, and
a hung kernel build or a pathological optimizer tail has nothing above it
to pull the plug.  This module rebuilds the bound at the two granularities
a chunk driver works in:

- **per-chunk budget** (:func:`call_with_deadline`): the chunk's fit runs in
  a worker thread; if it has not produced a result within ``budget_s`` the
  driver gets :class:`DeadlineExceeded` and moves on, marking the chunk's
  rows ``FitStatus.TIMEOUT``.  The overrunning computation is ABANDONED,
  not cancelled: nothing can interrupt a Python thread, and CUDA work it
  has queued runs to its end.  The abandoned worker keeps launching
  kernels on the card after :class:`DeadlineExceeded` until its fit
  returns; its results are discarded, and nothing here synchronizes the
  device to hide that.
- **per-job budget** (:class:`Deadline`): a monotonic wall-clock allotment
  for a whole chunk walk.  Once spent, remaining chunks are marked
  ``TIMEOUT`` *without dispatch*, so a job always terminates with an
  accurate per-chunk account instead of hanging past its SLO.

Both degrade gracefully by design: a timed-out chunk never aborts the job;
finished chunks keep their results and the partial output reports exact
per-row status counts.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Optional

from .. import obs

__all__ = ["Deadline", "DeadlineExceeded", "call_with_deadline",
           "current_lane", "current_request", "lane_context",
           "request_context"]

# -- lane identity -----------------------------------------------------------
# A sharded walk needs to know, from INSIDE a fit call, which lane
# dispatched it: the deterministic lane-targeted faults (the reference's
# faultinject.lane_kill / slow_lane / lane_oom_storm) key on it,
# and it keeps working across the thread hop call_with_deadline performs for
# budgeted chunks.  Thread-local by design — concurrent lanes each see their
# own id; code outside any lane sees None.
_lane_ctx = threading.local()


def current_lane() -> Optional[int]:
    """Shard id of the lane whose walk is executing on THIS thread (set by
    ``plan.LaneRunner`` around every chunk dispatch, and propagated into
    the watchdog worker thread for budgeted chunks); None outside a lane."""
    return getattr(_lane_ctx, "shard_id", None)


@contextlib.contextmanager
def lane_context(shard_id: Optional[int]):
    """Tag the current thread as running lane ``shard_id`` (None: untag)."""
    prev = getattr(_lane_ctx, "shard_id", None)
    _lane_ctx.shard_id = shard_id
    try:
        yield
    finally:
        _lane_ctx.shard_id = prev


# -- request identity --------------------------------------------------------
# The serving layer's twin of the lane tag: a FitServer batch walk serves
# several tenants' requests in ONE fit call, and the request-level fault
# injectors (the reference's faultinject.slow_tenant / server_kill)
# need to know, from inside a fit call, WHOSE work is on this thread.  The
# tag is the tuple of tenant ids riding the active micro-batch (or a single
# request's tenant for a solo run), propagated across the watchdog's worker
# thread hop exactly like the lane tag.


def current_request() -> Optional[tuple]:
    """Tenant tags of the serving request/batch executing on THIS thread
    (set by ``serving.FitServer`` around each batch walk); None outside."""
    return getattr(_lane_ctx, "request_tags", None)


@contextlib.contextmanager
def request_context(tags):
    """Tag the current thread as serving ``tags`` (a tuple of tenant ids;
    None: untag)."""
    prev = getattr(_lane_ctx, "request_tags", None)
    _lane_ctx.request_tags = tuple(tags) if tags is not None else None
    try:
        yield
    finally:
        _lane_ctx.request_tags = prev


class DeadlineExceeded(RuntimeError):
    """A fit dispatch (or the whole job) overran its wall-clock budget."""

    def __init__(self, label: str, budget_s: float):
        super().__init__(
            f"{label or 'fit dispatch'} exceeded its {budget_s:g}s wall-clock "
            "budget (reliability.watchdog)"
        )
        self.label = label
        self.budget_s = budget_s


class Deadline:
    """A monotonic wall-clock allotment for a whole job.

    ``budget_s=None`` means unbounded (every query answers "plenty left").
    The clock starts at construction — build it when the job starts.
    """

    def __init__(self, budget_s: Optional[float] = None):
        self.budget_s = None if budget_s is None else float(budget_s)
        self._t0 = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def remaining(self) -> Optional[float]:
        """Seconds left, or None when unbounded.  Can be negative."""
        if self.budget_s is None:
            return None
        return self.budget_s - self.elapsed()

    def exceeded(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0


def call_with_deadline(fn: Callable, budget_s: Optional[float] = None,
                       *, label: str = "", lane: Optional[int] = None):
    """Run ``fn()`` with at most ``budget_s`` seconds of wall clock.

    ``budget_s=None`` calls ``fn`` inline (zero overhead).  Otherwise ``fn``
    runs in a daemon worker thread and this call blocks up to ``budget_s``:
    a result (or the exception ``fn`` raised — re-raised here unchanged, so
    OOM backoff still sees RESOURCE_EXHAUSTED through the watchdog) within
    the budget is returned normally; overrunning raises
    :class:`DeadlineExceeded` and ABANDONS the worker — the computation is
    not cancelled (a Python thread cannot be interrupted, and it goes on
    launching on the card until its fit returns), its eventual result is
    discarded, and the thread dies with the process.

    ``lane=`` propagates the calling lane's identity into the worker
    thread (:func:`current_lane`), so lane-targeted fault injection and
    per-lane accounting survive the thread hop; ``None`` inherits the
    caller's lane tag.
    """
    if lane is None:
        lane = current_lane()
    req = current_request()  # serving request tag survives the hop too
    tctx = obs.current_trace()  # and so does the trace context
    if budget_s is None:
        with lane_context(lane):
            return fn()
    box: dict = {}
    done = threading.Event()

    def worker():
        try:
            with lane_context(lane), request_context(req), \
                    obs.trace_scope(tctx):
                box["result"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=worker, daemon=True,
                         name=f"watchdog:{label or 'fit'}")
    t.start()
    if not done.wait(timeout=float(budget_s)):
        obs.counter("watchdog.deadline_exceeded").inc()
        obs.event("watchdog.timeout", label=label, budget_s=float(budget_s))
        raise DeadlineExceeded(label, float(budget_s))
    if "error" in box:
        raise box["error"]
    return box["result"]

"""Deterministic distributed-trace contexts for the fleet.

One request's life crosses processes: a client submit, a backoff sleep,
an endpoint rotation, a ``not_leader`` redirect, a SIGKILLed primary, a
standby's write-ahead recovery, a bitwise re-answer.  This module gives
every one of those hops a shared identity — a **trace context** — so the
merged fleet streams (``tools/obs_report.py --fleet``) can reassemble a
single causal timeline per request.

Unlike Dapper-style tracers, ids here are NEVER random: a ``uuid4``
trace id would differ per process and per retry, which is exactly wrong
for a system whose requests already have content-derived identities and
whose replicas must continue each other's work byte-for-byte.  Instead:

- ``trace_id  = sha256("ststpu-trace:" + request_id)[:16]`` — every
  process that knows the request id derives the SAME trace id, with no
  wire state needed.  A standby re-answering a write-ahead request
  after a failover CONTINUES the dead primary's trace by construction.
- ``span_id   = sha256(trace_id + ":" + site)[:16]`` — a site is a
  causal segment ("client", "server", "server.batch"); the same segment
  on two replicas shares one id, which is the point: the failover
  re-dispatch IS the same segment, resumed elsewhere.
- ``parent_id`` links a child segment to the segment that caused it
  (the wire carries the caller's span id; the callee derives its own).

The context rides a thread-local that composes with
``watchdog.current_request`` (the deadline worker re-establishes both),
and :mod:`..obs.core` stamps it onto every recorder event and span line
as a top-level ``trace`` object (recorder schema v2).

**Bitwise inertness**: the plane flag here is flipped only by
``obs.enable`` / ``obs.disable``.  While the obs plane is off every
derivation helper returns ``None`` — no hashing happens, no context is
ever current, no ``trace`` key reaches a wire header or a recorder
line, so a disabled run is structurally identical to pre-tracing code.

This module is import-leaf (stdlib only; never imports ``obs.core``) so
the facade can re-export it without cycles.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager
from typing import NamedTuple, Optional

__all__ = [
    "TraceContext", "current", "derive_span_id", "derive_trace_id",
    "set_plane", "trace_for_request", "trace_from_wire", "trace_scope",
    "trace_to_wire",
]


class TraceContext(NamedTuple):
    """One causal segment of one request's fleet-wide timeline."""

    trace_id: str
    span_id: str
    parent_id: Optional[str] = None

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        return d


# flipped by obs.core.enable/disable (under the obs state lock); a plain
# bool read is atomic under the GIL and the OFF value makes every helper
# below an early-return no-op
_PLANE_ENABLED = False

_TLS = threading.local()


def set_plane(enabled: bool) -> None:
    """Gate the trace plane (called by ``obs.enable``/``obs.disable``
    only — never by library code; the obs-inert lint enforces that)."""
    global _PLANE_ENABLED
    _PLANE_ENABLED = bool(enabled)
    if not enabled:
        _TLS.ctx = None


def plane_enabled() -> bool:
    return _PLANE_ENABLED


def derive_trace_id(request_id: str) -> str:
    """The request's fleet-wide trace id: pure function of the request
    id, so every process derives the same one with no coordination."""
    return hashlib.sha256(
        f"ststpu-trace:{request_id}".encode()).hexdigest()[:16]


def derive_span_id(trace_id: str, site: str) -> str:
    """A causal segment's id within a trace: pure function of (trace,
    site), so a failover re-dispatch resumes the SAME segment id."""
    return hashlib.sha256(f"{trace_id}:{site}".encode()).hexdigest()[:16]


def current() -> Optional[TraceContext]:
    """This thread's active trace context (None when no trace is open
    or the plane is disabled)."""
    return getattr(_TLS, "ctx", None)


@contextmanager
def trace_scope(ctx: Optional[TraceContext]):
    """Make ``ctx`` the thread's active trace context for the block
    (restoring the prior one on exit).  ``trace_scope(None)`` is the
    documented cross-thread hop spelling: a worker re-establishing a
    caller that had no trace open simply clears its own."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def trace_for_request(request_id: Optional[str], site: str = "client",
                      parent_id: Optional[str] = None
                      ) -> Optional[TraceContext]:
    """Open (derive) the trace context for one request at one causal
    site.  Returns ``None`` — no hashing, no context — while the obs
    plane is disabled, which is what keeps disabled runs bitwise
    identical to pre-tracing code."""
    if not _PLANE_ENABLED or not request_id:
        return None
    tid = derive_trace_id(str(request_id))
    return TraceContext(tid, derive_span_id(tid, site), parent_id)


def trace_to_wire(ctx: Optional[TraceContext]) -> Optional[dict]:
    """The header-dict spelling a trace context rides the wire in
    (``encode_msg`` canonicalizes the header, so this stays a plain
    sorted-key-safe dict)."""
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id, "span_id": ctx.span_id}


def trace_from_wire(header: dict, site: str = "server"
                    ) -> Optional[TraceContext]:
    """Continue a wire-carried trace on the callee side: the callee's
    segment id is derived from (trace, site) and the caller's span id
    becomes the parent link.  Absent/malformed trace headers — and a
    disabled plane — yield ``None`` (old clients keep working)."""
    if not _PLANE_ENABLED:
        return None
    w = header.get("trace") if isinstance(header, dict) else None
    if not isinstance(w, dict):
        return None
    tid, parent = w.get("trace_id"), w.get("span_id")
    if not isinstance(tid, str) or not tid:
        return None
    return TraceContext(tid, derive_span_id(tid, site),
                        parent if isinstance(parent, str) else None)

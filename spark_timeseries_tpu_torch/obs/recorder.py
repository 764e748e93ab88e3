"""Flight recorder: bounded ring of structured events + JSONL stream.

The Spark event log (``spark.eventLog.enabled``) wrote every job/stage/task
transition to a file the history server replayed after a crash.  The
rebuild's analog is two-layered:

- a **ring buffer** of the last ``ring_size`` events always held in memory
  (cheap enough to leave on for long jobs — old events fall off the back),
  dumped to disk when a fit fails so the post-mortem starts with the tail
  of what the process was doing; and
- an optional **JSONL stream**: when the telemetry plane is enabled with a
  path, every event is also appended (and flushed — a SIGKILL loses at most
  the current line) to a file ``tools/obs_report.py`` renders.

One event = one flat JSON object.  Schema (``SCHEMA_VERSION``, v2):

- every line: ``ts`` (epoch seconds) and ``kind`` in
  ``meta | span | event | metrics``;
- ``meta``: first line of a stream — ``schema``, ``run_id``, ``pid``;
- ``span``: ``name``, ``t0``, ``wall_s``, ``process_s``, ``depth``,
  ``attrs`` (a closed span; emitted at exit);
- ``event``: ``name``, ``attrs`` (a point event: journal commit, OOM
  backoff, watchdog timeout, fit failure);
- ``metrics``: a full registry snapshot (``counters`` / ``gauges`` /
  ``histograms``), emitted at the end of an instrumented fit and on
  disable/dump.

Schema v2 adds an OPTIONAL top-level ``trace`` object on
``span`` and ``event`` lines, stamped by :mod:`.core` whenever a
:mod:`.tracing` context is active on the emitting thread:

- ``trace.trace_id``: 16 lowercase hex chars —
  ``sha256("ststpu-trace:" + request_id)[:16]``, identical in every
  process that handles the request (derivation, not propagation);
- ``trace.span_id``: 16 lowercase hex chars —
  ``sha256(trace_id + ":" + site)[:16]`` for the causal segment
  ("client", "server", "server.batch", ...) the line belongs to;
- ``trace.parent_id`` (optional): the caller segment's ``span_id``
  (the wire header carried it across the hop).

v1 streams (no ``trace`` anywhere) remain readable by every consumer;
``tools/obs_report.py --check`` accepts an absent ``trace`` and FAILS a
malformed one (wrong type, bad id shape) instead of letting it vanish.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

__all__ = ["SCHEMA_VERSION", "FlightRecorder"]

SCHEMA_VERSION = 2


class FlightRecorder:
    """Bounded event ring, optionally teeing every event to a JSONL file."""

    # lock-discipline contract (tools/lint lock-map): every instrumented
    # thread emits; ring, counter, and the teed file handle mutate only
    # under _lock (emit downgrades _file to None on a broken stream).
    _protected_by_ = {
        "_ring": "_lock",
        "events_emitted": "_lock",
        "_file": "_lock",
    }

    def __init__(self, run_id: str, ring_size: int = 4096,
                 jsonl_path: Optional[str] = None):
        self.run_id = run_id
        self.jsonl_path = jsonl_path
        self._ring = collections.deque(maxlen=int(ring_size))
        self._lock = threading.Lock()
        self._file = None
        self.events_emitted = 0
        if jsonl_path:
            d = os.path.dirname(os.path.abspath(jsonl_path))
            os.makedirs(d, exist_ok=True)
            self._file = open(jsonl_path, "a", encoding="utf-8")
        self.emit({"kind": "meta", "schema": SCHEMA_VERSION,
                   "run_id": run_id, "pid": os.getpid()})

    def emit(self, ev: dict) -> None:
        """Record one event (adds ``ts`` when absent; never raises — a
        telemetry write failure must not take down the fit it observes)."""
        ev.setdefault("ts", time.time())
        with self._lock:
            self._ring.append(ev)
            self.events_emitted += 1
            if self._file is not None:
                try:
                    self._file.write(json.dumps(ev, default=repr) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    # stream broken (disk full, closed fd): keep the ring
                    self._file = None

    def tail(self, n: Optional[int] = None) -> list:
        with self._lock:
            evs = list(self._ring)
        return evs if n is None else evs[-n:]

    def dump(self, path: str, extra_events: Optional[list] = None) -> str:
        """Write the ring tail (plus any closing events) to ``path``."""
        evs = self.tail()
        if extra_events:
            evs = evs + list(extra_events)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for ev in evs:
                f.write(json.dumps(ev, default=repr) + "\n")
        return path

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

"""Telemetry plane state: spans, the registry, the recorder, failure dumps
(port of ``obs/core.py``).

One process-global plane, **off by default**: every entry point checks a
single boolean and returns a shared no-op object when disabled, so the
instrumented paths (ladder rungs, sanitizer passes, straggler compactions
— never per-row work) pay one attribute load and one truthiness test.
There is deliberately no ambient "maybe enabled" middle state:
``enable()`` builds a fresh registry + recorder under a new run id,
``disable()`` emits a final metrics snapshot and tears both down, and
nothing instrumented can alter what a fit computes — telemetry observes
timings and counts, never tensors.

Spans nest per thread (the watchdog runs fits on worker threads, and a
worker's spans must not splice into the driver thread's stack) and
measure **host** wall clock plus process CPU time.  A span does not
synchronize the device: PyTorch launches CUDA work asynchronously, so a
span around a fit that reads nothing back closes when the work is queued,
not when the card finishes it.  The fits this plane wraps read their
results to the host (status, parameters) before returning, which is what
makes their spans cover the device time; the plane itself never adds a
``synchronize``.  ``first_dispatch()`` lets a chunk driver label the first
dispatch of each (fit, shape) pair as ``compile+execute`` — here the
first call of a kernel builds or loads its library — and steady-state
calls as ``execute``.

``profile=True`` additionally wraps every span in a
``torch.profiler.record_function`` range of the same name, so a
``torch.profiler`` capture shows the exact spans the JSONL reports — one
vocabulary across both tools.
"""

from __future__ import annotations

import functools
import os
import tempfile
import threading
import time
import uuid
from typing import Optional

from . import tracing
from .memory import peak_memory
from .metrics import NULL_METRIC, MetricsRegistry
from .recorder import SCHEMA_VERSION, FlightRecorder

__all__ = [
    "Span",
    "counter",
    "disable",
    "dump_failure",
    "dump_on_failure",
    "emit_metrics",
    "enable",
    "enable_from_env",
    "enabled",
    "event",
    "first_dispatch",
    "gauge",
    "histogram",
    "last_crash_dump",
    "snapshot",
    "span",
    "stream_path",
    "summary",
]


class _State:
    __slots__ = ("enabled", "run_id", "metrics", "recorder", "profile",
                 "crash_dump_dir", "seen_programs", "last_crash",
                 "crash_seq", "last_dumped_error")

    def __init__(self):
        self.enabled = False
        self.run_id = None
        self.metrics = MetricsRegistry()
        self.recorder: Optional[FlightRecorder] = None
        self.profile = False
        self.crash_dump_dir = None
        self.seen_programs = set()
        self.last_crash = None
        self.crash_seq = 0
        self.last_dumped_error = None


_STATE = _State()
_LOCK = threading.RLock()
_TLS = threading.local()


# -- lifecycle ---------------------------------------------------------------


def enabled() -> bool:
    return _STATE.enabled


def enable(jsonl_path: Optional[str] = None, *, ring_size: int = 4096,
           profile: bool = False, crash_dump_dir: Optional[str] = None) -> str:
    """Turn the telemetry plane on under a fresh run id (returned).

    ``jsonl_path``: tee every event to this JSONL file (appended, flushed
    per event) in addition to the in-memory ring; ``ring_size`` bounds the
    ring; ``profile=True`` mirrors spans into ``torch.profiler`` ranges
    (``record_function``); ``crash_dump_dir`` overrides where failure dumps
    land (default: the JSONL's directory, else the system temp dir).  Calling
    while already enabled finalizes the previous run first — metrics never
    bleed across runs.
    """
    with _LOCK:
        if _STATE.enabled:
            disable()
        _STATE.run_id = uuid.uuid4().hex[:12]
        _STATE.metrics = MetricsRegistry()
        _STATE.recorder = FlightRecorder(_STATE.run_id, ring_size=ring_size,
                                         jsonl_path=jsonl_path)
        _STATE.profile = bool(profile)
        _STATE.crash_dump_dir = crash_dump_dir
        _STATE.seen_programs = set()
        _STATE.crash_seq = 0
        _STATE.last_crash = None
        _STATE.last_dumped_error = None
        _STATE.enabled = True
        tracing.set_plane(True)
        return _STATE.run_id


def disable() -> None:
    """Finalize the run: emit a closing metrics snapshot, close the
    stream, and return every entry point to its no-op fast path.
    Idempotent — disabling a disabled plane does nothing."""
    with _LOCK:
        if not _STATE.enabled:
            return
        rec = _STATE.recorder
        _STATE.enabled = False  # stop new events before the final snapshot
        tracing.set_plane(False)
        if rec is not None:
            rec.emit({"kind": "metrics", **_STATE.metrics.snapshot()})
            rec.close()
        _STATE.recorder = None
        _STATE.profile = False


def enable_from_env() -> None:
    """Honor ``STSTPU_OBS=1`` (+ ``STSTPU_OBS_JSONL=path``,
    ``STSTPU_OBS_PROFILE=1``) so bench/CI runs opt in without code.

    Runs at package import, so it must never raise: an unusable JSONL
    path (read-only dir, bad mount) degrades to a warning with telemetry
    off rather than breaking ``import spark_timeseries_tpu_torch`` for a
    program that never touches the plane.
    """
    if os.environ.get("STSTPU_OBS", "").lower() not in ("1", "true", "on",
                                                        "yes"):
        return
    try:
        enable(os.environ.get("STSTPU_OBS_JSONL") or None,
               profile=os.environ.get("STSTPU_OBS_PROFILE", "") == "1")
    except Exception as e:  # noqa: BLE001 - telemetry must not break import
        import warnings

        _STATE.enabled = False
        tracing.set_plane(False)
        warnings.warn(f"STSTPU_OBS=1 but enabling telemetry failed "
                      f"({type(e).__name__}: {e}); continuing with the "
                      "plane disabled", stacklevel=2)


# -- metrics / events --------------------------------------------------------


def counter(name: str):
    st = _STATE
    return st.metrics.counter(name) if st.enabled else NULL_METRIC


def gauge(name: str):
    st = _STATE
    return st.metrics.gauge(name) if st.enabled else NULL_METRIC


def histogram(name: str):
    st = _STATE
    return st.metrics.histogram(name) if st.enabled else NULL_METRIC


def event(name: str, **attrs) -> None:
    """Record a point event in the ring (and JSONL stream when configured)."""
    st = _STATE
    rec = st.recorder  # local capture: a concurrent disable() nulls the
    if st.enabled and rec is not None:  # attribute between check and use
        ev = {"kind": "event", "name": name}
        if attrs:
            ev["attrs"] = attrs
        ctx = tracing.current()
        if ctx is not None:
            ev["trace"] = ctx.to_dict()
        rec.emit(ev)


def snapshot() -> Optional[dict]:
    """Current metrics snapshot, or None when disabled."""
    st = _STATE
    return st.metrics.snapshot() if st.enabled else None


def emit_metrics() -> None:
    """Append a metrics-snapshot line to the event stream (end of a fit)."""
    st = _STATE
    rec = st.recorder
    if st.enabled and rec is not None:
        rec.emit({"kind": "metrics", **st.metrics.snapshot()})


def stream_path() -> Optional[str]:
    """The enabled run's JSONL stream path (None when disabled or when
    the recorder is ring-only) — sidecar artifacts (the client's clock
    journal) land NEXT TO the stream, and this is how they find it."""
    st = _STATE
    rec = st.recorder  # local capture vs a concurrent disable()
    if not st.enabled or rec is None:
        return None
    return rec.jsonl_path


def first_dispatch(key) -> bool:
    """True exactly once per ``key`` per run — the chunk driver keys on
    (fit identity, chunk shape, dtype) to tag trace+compile dispatches."""
    st = _STATE
    if not st.enabled:
        return False
    with _LOCK:
        if key in st.seen_programs:
            return False
        st.seen_programs.add(key)
        return True


# -- spans -------------------------------------------------------------------


class Span:
    """A closed wall/process-time measurement, recorded at ``__exit__``.

    After the block, ``wall_s`` / ``process_s`` hold the measured times —
    instrumented drivers read them to embed per-chunk numbers in result
    metadata without re-measuring.
    """

    __slots__ = ("name", "attrs", "t0", "wall_s", "process_s", "depth",
                 "_p0", "_ts0", "_ann")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.wall_s = None
        self.process_s = None
        self.depth = 0
        self._ann = None

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        self.depth = len(stack)
        stack.append(self)
        if _STATE.profile:
            try:
                from torch.profiler import record_function

                self._ann = record_function(self.name)
                self._ann.__enter__()
            except Exception:  # noqa: BLE001 - profiling is best-effort
                self._ann = None
        self._ts0 = time.time()
        self._p0 = time.process_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.wall_s = time.perf_counter() - self.t0
        self.process_s = time.process_time() - self._p0
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        stack = getattr(_TLS, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:  # out-of-order exit: stay consistent
            stack.remove(self)
        st = _STATE
        rec = st.recorder  # local capture: disable() may null it between
        if st.enabled and rec is not None:  # the check and the emit
            ev = {"kind": "span", "name": self.name, "t0": self._ts0,
                  "wall_s": round(self.wall_s, 6),
                  "process_s": round(self.process_s, 6), "depth": self.depth}
            if self.attrs:
                ev["attrs"] = self.attrs
            if exc_type is not None:
                ev["error"] = exc_type.__name__
            ctx = tracing.current()
            if ctx is not None:
                ev["trace"] = ctx.to_dict()
            rec.emit(ev)
            st.metrics.histogram(f"span.{self.name}").observe(self.wall_s)
        return False


class _NullSpan:
    """Disabled-path span: one shared instance, every method a no-op."""

    __slots__ = ()
    wall_s = None
    process_s = None
    depth = 0

    def set(self, **attrs) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


def span(name: str, **attrs):
    """Open a nested timing span: ``with obs.span("chunk", lo=0): ...``.

    Disabled plane -> the shared no-op span (no allocation beyond the
    kwargs dict at the call site)."""
    if not _STATE.enabled:
        return NULL_SPAN
    return Span(name, attrs)


# -- run summary / failure dumps --------------------------------------------


def summary(counters_since: Optional[dict] = None, **extra) -> Optional[dict]:
    """The per-fit telemetry block embedded in journal manifests and
    ``ResilientFitResult.meta["telemetry"]``; None when disabled.

    Always carries a non-null ``peak_memory`` on any working interpreter
    (the CUDA allocator's peak once CUDA is initialized, host peak RSS
    otherwise — ``obs.memory.peak_memory``), the metric snapshot, and
    whatever driver-level ``extra`` the instrumented caller adds (per-chunk
    span rows, resume accounting).  ``counters_since`` is a counter baseline
    (a prior snapshot's ``counters`` map): counters are then reported as
    DELTAS from it, so one ``enable()`` spanning several fits yields
    per-fit counts instead of attributing fit A's failures to fit B's
    manifest.  Gauges and histograms stay run-cumulative (a peak or a
    latency distribution has no meaningful subtraction).
    """
    st = _STATE
    if not st.enabled:
        return None
    pm = peak_memory()
    if pm.bytes is not None:
        st.metrics.gauge("memory.peak_bytes").max(pm.bytes)
        st.metrics.gauge("memory.source").set(pm.source)
    snap = st.metrics.snapshot()
    if counters_since:
        snap["counters"] = {k: v - counters_since.get(k, 0)
                            for k, v in snap["counters"].items()}
    rec = st.recorder  # local capture vs a concurrent disable()
    out = {
        "schema": SCHEMA_VERSION,
        "run_id": st.run_id,
        "jsonl_path": rec.jsonl_path if rec else None,
        "events_recorded": rec.events_emitted if rec else 0,
        "peak_memory": {"bytes": pm.bytes, "source": pm.source},
        **snap,
    }
    out.update(extra)
    return out


def dump_failure(context: str, error: Optional[BaseException] = None
                 ) -> Optional[str]:
    """Dump the flight-recorder tail for a failed fit; returns the path.

    Best-effort by contract: any internal failure is swallowed (the
    original fit exception must propagate undisturbed), and the same
    exception object is dumped at most once even when several instrumented
    layers (resilient_fit inside fit_chunked inside panel.fit) unwind
    through their own dump hooks.
    """
    st = _STATE
    rec = st.recorder  # local capture vs a concurrent disable()
    if not st.enabled or rec is None:
        return None
    try:
        with _LOCK:
            if error is not None and st.last_dumped_error is not None \
                    and st.last_dumped_error() is error:
                return st.last_crash
            st.crash_seq += 1
            seq = st.crash_seq
        d = st.crash_dump_dir
        if d is None and rec.jsonl_path:
            d = os.path.dirname(os.path.abspath(rec.jsonl_path))
        if d is None:
            d = tempfile.gettempdir()
        path = os.path.join(d, f"obs-crash-{st.run_id}-{seq:02d}.jsonl")
        closing = [
            {"kind": "event", "name": "fit.failure", "ts": time.time(),
             "attrs": {"context": context,
                       "error": (f"{type(error).__name__}: {error}"[:300]
                                 if error is not None else None)}},
            {"kind": "metrics", "ts": time.time(), **st.metrics.snapshot()},
        ]
        rec.emit(closing[0])
        rec.dump(path, extra_events=closing[1:])
        with _LOCK:
            st.last_crash = path
            if error is not None:
                import weakref

                try:
                    st.last_dumped_error = weakref.ref(error)
                except TypeError:  # some exceptions are not weakref-able
                    st.last_dumped_error = None
        return path
    except Exception:  # noqa: BLE001 - telemetry must never mask the fit error
        return None


def last_crash_dump() -> Optional[str]:
    """Path of the most recent failure dump this run, or None."""
    return _STATE.last_crash


def dump_on_failure(context: str, unless=None):
    """Decorator: dump the recorder tail when the wrapped fit raises.

    Zero-cost when disabled (the enabled check runs before any try frame
    matters); the exception always re-raises unchanged.  ``unless`` is a
    predicate on the exception that SKIPS the dump — a caller above may
    treat the error as recoverable (``resilient_fit`` passes the
    RESOURCE_EXHAUSTED check: the chunk driver's backoff handles those,
    and a successful run must not leave crash dumps behind).
    """

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _STATE.enabled:
                return fn(*args, **kwargs)
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                if unless is None or not unless(e):
                    dump_failure(context, e)
                raise

        return wrapped

    return deco

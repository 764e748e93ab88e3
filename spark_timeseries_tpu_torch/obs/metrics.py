"""Metrics registry: counters, gauges, histograms — host-side, zero-dep.

Spark's executor heartbeats shipped per-task metric maps (shuffle bytes,
GC time, spill counts) to the driver, which aggregated them per stage; our
single-process rebuild needs only a process-local registry, but the same
taxonomy: monotonically increasing **counters** (ladder-rung rescues, OOM
backoff halvings, kernel-cache hits), point-in-time **gauges** (peak device
memory, chunk size in effect), and **histograms** of repeated measurements
(journal commit latency, span wall times) summarized as
count/sum/min/max/last — enough for the ``tools/obs_report.py`` table and
the manifest telemetry block without retaining unbounded samples.

Everything here is plain Python on the host: no torch import, no device
work, safe to call from watchdog worker threads (one lock per registry;
increments are far off any per-row hot loop — per chunk, per rung, per
dispatch at most).
"""

from __future__ import annotations

import threading
from typing import Dict

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_METRIC"]


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += int(n)

    # counters and gauges share call sites via duck typing
    add = inc


class Gauge:
    """A point-in-time value (last write wins)."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.value = None
        self._lock = lock

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def max(self, v) -> None:
        """Keep the running maximum (peak-style gauges)."""
        with self._lock:
            if self.value is None or v > self.value:
                self.value = v


class Histogram:
    """Streaming summary of repeated observations (count/sum/min/max/last).

    Deliberately no buckets or reservoir: the consumers (manifest telemetry
    block, ``obs_report`` table) want one-line summaries, and a bounded
    ring of raw events already lives in the flight recorder.
    """

    __slots__ = ("name", "count", "total", "min", "max", "last", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.last = None
        self._lock = lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.last = v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v

    def summary(self) -> dict:
        with self._lock:
            if not self.count:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": round(self.total, 6),
                "mean": round(self.total / self.count, 6),
                "min": round(self.min, 6),
                "max": round(self.max, 6),
                "last": round(self.last, 6),
            }


class _NullMetric:
    """The disabled path: every mutator is a bound no-op, one shared
    instance — ``obs.counter(...)`` costs a dict-free attribute call and
    allocates nothing when telemetry is off."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass

    add = inc

    def set(self, v) -> None:
        pass

    def max(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


NULL_METRIC = _NullMetric()


class MetricsRegistry:
    """Name -> metric, created on first touch (Prometheus-style)."""

    # lock-discipline contract (tools/lint lock-map): any instrumented
    # thread (driver, committer, lanes, abandoned watchdog workers) may
    # create a metric; the name->metric maps mutate under _lock (the
    # racy pre-check read is a fast path — setdefault under the lock is
    # what actually inserts).
    _protected_by_ = {
        "_counters": "_lock",
        "_gauges": "_lock",
        "_histograms": "_lock",
    }

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, self._lock))
        return h

    def snapshot(self) -> dict:
        """JSON-ready dump of every metric (sorted for stable artifacts).

        The name->metric maps are copied UNDER the lock (an abandoned
        watchdog worker can still be creating metrics while the driver
        snapshots) and the values read outside it — ``Histogram.summary``
        takes the same lock, so reading inside would self-deadlock.
        """
        with self._lock:
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            histograms = sorted(self._histograms.items())
        return {
            "counters": {k: v.value for k, v in counters},
            "gauges": {k: v.value for k, v in gauges},
            "histograms": {k: v.summary() for k, v in histograms},
        }

"""Write-back output sink: stream chunk results OUT as durable shards
(port of ``reliability/sink.py``).

Without a sink, ``fit_chunked`` assembles every chunk's host arrays and
concatenates them into one result — an O(panel) host allocation that the
chunk sources (:mod:`.source`) avoid on the INPUT side only.
:class:`WritableChunkSource` closes the output half: each
committed chunk's arrays are handed to a double-buffered background
writer that lands them as ``out_{lo}_{hi}.npz`` shards next to the
journal, through the same ``durable_replace`` tmp→fsync→rename protocol
journal shards use.  A SIGKILL mid-write leaves only a hidden
``.tmp-*`` orphan, which every shard reader already excludes — output
shards get exactly the torn-file rejection input shards have.

The sink is idempotent per span: a resumed walk re-emits its
journal-loaded chunks through the sink, and re-writing a span durably
replaces the same shard with the same bytes — so a killed-and-resumed
sink directory finalizes bitwise-identical to an uninterrupted one.

``finalize(n_rows)`` drains the writer, verifies the recorded spans
tile ``[0, n_rows)`` exactly, deletes orphan shards from an earlier run
on a different chunk grid, and writes a durable ``sink_manifest.json``
naming every shard — the block ``tools/obs_report.py --check``
validates.  Read the results back at O(chunk) host footprint with
``NpzShardSource(directory, key="params")``.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Optional, Sequence

import numpy as np

from .journal import _atomic_write_bytes, durable_replace

__all__ = ["SinkError", "WritableChunkSource", "SINK_MANIFEST",
           "SINK_VERSION"]

SINK_MANIFEST = "sink_manifest.json"
SINK_VERSION = 1

_STOP = object()


class SinkError(RuntimeError):
    """A write-back sink failed or finalized over an incomplete walk."""


class _Item:
    __slots__ = ("lo", "hi", "arrays", "nbytes")

    def __init__(self, lo: int, hi: int, arrays: dict, nbytes: int):
        self.lo, self.hi, self.arrays, self.nbytes = lo, hi, arrays, nbytes


class WritableChunkSource:
    """Double-buffered durable writer for one walk's output shards.

    ``write(lo, hi, arrays)`` queues one chunk's host arrays (the
    journal shard schema) for background write; at most ``depth`` chunks
    are in flight, so the sink's host footprint is O(depth × chunk) by
    construction — ``peak_in_flight_bytes`` proves it.  ``write`` blocks
    under backpressure (accounted as ``blocked_s``) and re-raises the
    worker's first error, which is also re-raised at ``finalize``.
    """

    # lock-discipline contract (tools/lint lock-map): shared between the
    # driver/committer thread calling write() and the sink worker.
    _protected_by_ = {
        "_spans": "_lock",
        "_fields": "_lock",
        "_param_width": "_lock",
        "_status_counts": "_lock",
        "_writes": "_lock",
        "_bytes_written": "_lock",
        "_write_wall_s": "_lock",
        "_in_flight_bytes": "_lock",
        "_peak_in_flight_bytes": "_lock",
        "_error": "_lock",
    }

    def __init__(self, directory, *, depth: int = 2):
        self.directory = os.path.abspath(os.fspath(directory))
        os.makedirs(self.directory, exist_ok=True)
        self.depth = max(1, int(depth))
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._lock = threading.Lock()
        self._spans: dict = {}  # lo -> (hi, shard_name)
        self._fields: Optional[Sequence[str]] = None
        self._param_width: Optional[int] = None
        self._status_counts: dict = {}
        self._writes = 0
        self._bytes_written = 0
        self._write_wall_s = 0.0
        self._blocked_s = 0.0  # driver-only
        self._in_flight_bytes = 0
        self._peak_in_flight_bytes = 0
        self._error: Optional[BaseException] = None
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="sink-writer")
        self._worker.start()

    # -- worker side --------------------------------------------------------

    def _run(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                self._q.task_done()
                return
            try:
                with self._lock:
                    failed = self._error is not None
                if not failed:
                    self._write_one(item)
            except BaseException as e:  # noqa: BLE001 - re-raised in driver
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                with self._lock:
                    self._in_flight_bytes -= item.nbytes
                self._q.task_done()

    def _shard_name(self, lo: int, hi: int) -> str:
        return f"out_{lo:09d}_{hi:09d}.npz"

    def _write_one(self, item: _Item):
        t0 = time.perf_counter()
        shard = self._shard_name(item.lo, item.hi)
        path = os.path.join(self.directory, shard)
        durable_replace(path, lambda f: np.savez(f, **item.arrays),
                        suffix=".npz")
        status = item.arrays.get("status")
        with self._lock:
            self._spans[item.lo] = (item.hi, shard)
            if self._fields is None:
                self._fields = tuple(sorted(item.arrays))
            params = item.arrays.get("params")
            if self._param_width is None and params is not None \
                    and getattr(params, "ndim", 0) == 2:
                self._param_width = int(params.shape[1])
            if status is not None:
                vals, counts = np.unique(np.asarray(status),
                                         return_counts=True)
                for v, c in zip(vals.tolist(), counts.tolist()):
                    k = str(int(v))
                    self._status_counts[k] = \
                        self._status_counts.get(k, 0) + int(c)
            self._writes += 1
            self._bytes_written += item.nbytes
            self._write_wall_s += time.perf_counter() - t0

    # -- driver side --------------------------------------------------------

    def check(self) -> None:
        """Re-raise the worker's pending error (if any) in the caller."""
        with self._lock:
            err = self._error
        if err is not None:
            raise SinkError(
                f"write-back sink {self.directory} failed: {err}") from err

    @property
    def param_width(self) -> Optional[int]:
        with self._lock:
            return self._param_width

    def write(self, lo: int, hi: int, arrays: dict) -> None:
        """Queue one chunk's host arrays for durable background write.

        Idempotent per ``[lo, hi)``: re-emitting a span (journal resume)
        durably replaces the same shard.  Blocks while ``depth`` writes
        are in flight — the O(chunk) footprint bound."""
        self.check()
        if self._closed:
            raise SinkError("write() on a finalized sink")
        arrays = {k: np.asarray(v) for k, v in arrays.items()}
        nbytes = sum(int(v.nbytes) for v in arrays.values())
        item = _Item(int(lo), int(hi), arrays, nbytes)
        with self._lock:
            self._in_flight_bytes += nbytes
            if self._in_flight_bytes > self._peak_in_flight_bytes:
                self._peak_in_flight_bytes = self._in_flight_bytes
        t0 = time.perf_counter()
        while True:
            try:
                self._q.put(item, timeout=0.05)
                break
            except queue.Full:
                try:
                    self.check()  # a failed worker never frees the slot
                except BaseException:
                    with self._lock:
                        self._in_flight_bytes -= nbytes
                    raise
        self._blocked_s += time.perf_counter() - t0

    def barrier(self) -> None:
        """Block until every queued write is durable, then surface any
        worker error."""
        t0 = time.perf_counter()
        self._q.join()
        self._blocked_s += time.perf_counter() - t0
        self.check()

    def discard_from(self, lo: int) -> None:
        """Drop recorded spans at/after ``lo`` (walk rollback): their
        chunks are about to be recomputed on a different grid."""
        self._q.join()
        with self._lock:
            drop = [s for s in self._spans if s >= int(lo)]
            names = [self._spans.pop(s)[1] for s in drop]
        for name in names:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    def finalize(self, n_rows: int) -> dict:
        """Drain, verify the spans tile ``[0, n_rows)``, sweep orphan
        shards from earlier grids, and write ``sink_manifest.json``
        durably.  Returns the accounting dict (also the manifest's
        accounting block)."""
        if not self._closed:
            self._closed = True
            t0 = time.perf_counter()
            self._q.join()
            self._blocked_s += time.perf_counter() - t0
            self._q.put(_STOP)
            self._worker.join(timeout=30.0)
        self.check()
        with self._lock:
            spans = sorted((lo, hi, name)
                           for lo, (hi, name) in self._spans.items())
        pos = 0
        for lo, hi, _name in spans:
            if lo != pos:
                raise SinkError(
                    f"sink {self.directory} has a gap: rows [{pos}, {lo}) "
                    "were never written")
            pos = hi
        if pos != int(n_rows):
            raise SinkError(
                f"sink {self.directory} covers [0, {pos}) but the walk "
                f"spans [0, {n_rows})")
        keep = {name for _lo, _hi, name in spans}
        for fname in os.listdir(self.directory):
            if fname.startswith("out_") and fname.endswith(".npz") \
                    and fname not in keep:
                # an earlier run on a different chunk grid: its spans are
                # fully superseded by this run's verified tiling
                try:
                    os.unlink(os.path.join(self.directory, fname))
                except OSError:
                    pass
        acct = self.accounting()
        manifest = {
            "kind": "sink",
            "sink_version": SINK_VERSION,
            "n_rows": int(n_rows),
            "fields": list(self._fields or ()),
            "shards": [{"name": name, "lo": lo, "hi": hi}
                       for lo, hi, name in spans],
            "accounting": acct,
        }
        _atomic_write_bytes(
            os.path.join(self.directory, SINK_MANIFEST),
            (json.dumps(manifest, indent=1, sort_keys=True) + "\n")
            .encode())
        return acct

    def accounting(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "depth": self.depth,
                "writes": self._writes,
                "spans": len(self._spans),
                "bytes_written": int(self._bytes_written),
                "write_wall_s": round(self._write_wall_s, 6),
                "blocked_s": round(self._blocked_s, 6),
                "peak_in_flight_bytes": int(self._peak_in_flight_bytes),
                "status_counts": dict(self._status_counts),
            }

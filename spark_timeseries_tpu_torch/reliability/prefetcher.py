"""Background chunk prefetcher: stage the NEXT chunk while the current
chunk computes (port of ``reliability/prefetcher.py``).

The committer (:mod:`.committer`) hides the journal's *output* side — host
fetch + shard + manifest I/O run on a worker while the card computes the
next chunk.  This module is the input half of that pipeline, mirroring the
committer's design: ONE daemon worker thread that drains a bounded FIFO of
staging requests, and for each takes ``panel[lo:hi]`` — the SAME
expression the serial driver uses, so the chunk holds identical bytes.

For a tensor panel that is a row view (no device work).  For a lane view
over a host-resident :class:`~.source.ChunkSource` it is a genuine
host→device staging — host read into a pooled pinned buffer plus an
asynchronous copy — and this worker is what overlaps it: the worker runs
on its **own** ``torch.cuda.Stream``, so chunk N+1's copy runs while chunk
N's kernels run on the fit's stream (on the fit's stream it would queue
behind them and nothing would overlap).  A staged chunk is handed over
with an event: the taking thread's current stream waits on it
(``wait_event``), and the tensor is marked as used by that stream
(``record_stream``), so the caching allocator cannot recycle its memory
for the staging stream while the fit still reads it.  The staged tensor is
handed to the driver with no reference retained (slot cleared at take), so
the allocator recycles chunk N's memory for chunk N+2 — the donated-buffer
half of the O(chunk)-footprint contract.

With the committer draining finished chunks behind the walk and the
prefetcher staging chunks ahead of it, the steady state is the full
three-stage overlap: **stage N+1 ∥ compute N ∥ commit N−1**.

**Prediction, not speculation**: the driver schedules exactly the spans
the walk will visit next (up to ``depth`` consecutive ones, with
committed-grid clamping, torn-shard forced boundaries, and the current
chunk size all applied by the driver before scheduling).  When the walk
deviates anyway — an OOM backoff halves the chunk size, or a committer
rollback rewinds the walk — the driver **invalidates** the staged chunks;
a ``take`` that finds no matching span simply slices inline (a recorded
miss), so a stale prediction can cost at most the work it saved, never
correctness: the staged chunk either IS ``panel[lo:hi]`` for the
requested span or it is not used.

**Bounded depth** (``prefetch_depth``, default 1): at most ``depth``
staged-but-untaken chunks exist at any time, bounding the extra device
memory to ``depth`` chunk buffers.  Depth 1 is the classic double buffer
(chunk N computing, chunk N+1 staged).

**Errors** never vanish into the worker: a staging failure (typically an
out-of-memory error — the staged chunk is a fresh device allocation) is
delivered at ``take`` for that span, where the chunk driver's normal
fit-time OOM handling rolls it into the backoff ladder.

**Accounting**: the worker records the staging wall per chunk; ``take``
records the driver wall spent waiting on an in-flight staging.  Their
difference is the input-staging cost the overlap hid —
``stats().hidden_s`` — published next to the committer's numbers as
``meta["pipeline"]`` input-side fields and the
``input_overlap_efficiency``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import NamedTuple, Optional

import torch

from .. import obs

__all__ = ["ChunkPrefetcher", "PrefetchStats"]

_STOP = object()


class PrefetchStats(NamedTuple):
    """Driver-facing accounting of one prefetcher's lifetime."""

    staged: int  # chunks the worker finished staging
    hits: int  # takes served from a staged/in-flight chunk
    misses: int  # takes that had to slice inline
    staging_wall_s: float  # total dispatch+materialize wall in the worker
    blocked_s: float  # driver wall spent waiting in take()
    invalidated: int  # staged/pending slices dropped by the driver

    @property
    def hidden_s(self) -> float:
        """Staging wall the driver never waited for — hidden under the
        previous chunk's compute (and host work)."""
        return max(0.0, self.staging_wall_s - self.blocked_s)


class _Slot:
    """One staged (or in-flight) chunk; ``ready`` is the CUDA event recorded
    on the staging stream after it (None off the card)."""

    __slots__ = ("event", "value", "error", "cancelled", "ready")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error = None
        self.cancelled = False
        self.ready = None


class ChunkPrefetcher:
    """Bounded background chunk stager for one chunk walk over ``panel``.

    ``schedule(lo, hi)`` requests staging of ``panel[lo:hi]`` (ignored
    when ``depth`` chunks are already staged/in flight, or the span is
    already scheduled); ``take(lo, hi)`` returns the staged chunk when
    the prediction matched (waiting out an in-flight staging) and slices
    inline otherwise; ``invalidate()`` drops every staged/pending chunk
    (OOM backoff / rollback re-chunked the walk).  ``close()`` stops the
    worker and returns :class:`PrefetchStats`.  ``device`` is where the
    staged chunks live: on a CUDA device the worker stages on a stream of
    its own.
    """

    # lock-discipline contract (tools/lint lock-map): slot map + stats
    # are mutated from both the driver (schedule/take/invalidate) and
    # the staging worker; every site holds _lock.  _closed and the
    # queue handle are driver-only.
    _protected_by_ = {
        "_slots": "_lock",
        "_staged": "_lock",
        "_hits": "_lock",
        "_misses": "_lock",
        "_staging_wall_s": "_lock",
        "_blocked_s": "_lock",
        "_invalidated": "_lock",
    }

    def __init__(self, panel, *, depth: int = 1, device=None):
        self._panel = panel
        self.depth = max(1, int(depth))
        device = torch.device("cpu" if device is None else device)
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(device) if device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue()
        self._slots: dict = {}  # (lo, hi) -> _Slot
        self._lock = threading.Lock()
        self._staged = 0
        self._hits = 0
        self._misses = 0
        self._staging_wall_s = 0.0
        self._blocked_s = 0.0
        self._invalidated = 0
        self._closed = False
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="chunk-prefetcher")
        self._worker.start()

    # -- worker side --------------------------------------------------------

    def _run(self):
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            self._serve()

    def _serve(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            lo, hi, slot = item
            # drop the tuple's slot reference immediately: the worker
            # blocks in q.get() between requests, and a lingering local
            # would pin the previous staged buffer (= one chunk of device
            # memory) for that whole idle stretch
            item = None
            if slot.cancelled:
                slot.event.set()
                slot = None
                continue
            t0 = time.perf_counter()
            try:
                with obs.span("stage.overlap", lo=lo, hi=hi):
                    # the SAME slice expression the serial driver uses:
                    # identical bytes
                    vals = self._panel[lo:hi]
                    if self._stream is not None:
                        # the taker's stream waits on this, never the host
                        slot.ready = torch.cuda.Event()
                        slot.ready.record(self._stream)
                slot.value = vals
                vals = None
            except BaseException as e:  # noqa: BLE001 - re-raised at take()
                slot.error = e
            wall = time.perf_counter() - t0
            with self._lock:
                self._staging_wall_s += wall
                if slot.error is None and not slot.cancelled:
                    self._staged += 1
                cancelled = slot.cancelled
            if cancelled:
                # invalidated mid-staging: free the buffer BEFORE signaling
                # — invalidate() waits on this event precisely so the memory
                # is back when its caller (the OOM-backoff retry) launches
                slot.value = None
            obs.counter("prefetch.staged").inc()
            slot.event.set()
            slot = None

    # -- driver side --------------------------------------------------------

    def schedule(self, lo: int, hi: int) -> None:
        """Request staging of ``panel[lo:hi]`` (bounded, idempotent)."""
        if self._closed:
            return
        lo, hi = int(lo), int(hi)
        with self._lock:
            if (lo, hi) in self._slots or len(self._slots) >= self.depth:
                return
            slot = _Slot()
            self._slots[(lo, hi)] = slot
        self._q.put((lo, hi, slot))
        obs.gauge("prefetch.queue_depth").set(len(self._slots))

    def take(self, lo: int, hi: int):
        """The chunk for ``[lo, hi)`` — staged when predicted, inline
        otherwise.  Also drops staged chunks the walk has passed (their
        ``lo`` is behind the requested one), so a resume-skipped span
        cannot pin a depth slot forever.  Re-raises a staging-time error
        (e.g. an out-of-memory error) in the driver.  A staged chunk is
        ordered before the calling thread's current stream (``wait_event``)
        and recorded as used by it (``record_stream``)."""
        lo, hi = int(lo), int(hi)
        with self._lock:
            slot = self._slots.pop((lo, hi), None)
            stale = [k for k in self._slots if k[0] < hi]
            for k in stale:
                self._slots.pop(k).cancelled = True
            self._invalidated += len(stale)
        if slot is None:
            with self._lock:
                self._misses += 1
            obs.counter("prefetch.misses").inc()
            return self._panel[lo:hi]
        t0 = time.perf_counter()
        slot.event.wait()
        blocked = time.perf_counter() - t0
        with self._lock:
            self._blocked_s += blocked
            if slot.error is None:
                self._hits += 1
        if slot.error is not None:
            err, slot.error = slot.error, None
            raise err
        obs.counter("prefetch.hits").inc()
        vals = slot.value
        if slot.ready is not None:
            consumer = torch.cuda.current_stream(vals.device)
            consumer.wait_event(slot.ready)
            vals.record_stream(consumer)
        return vals

    def invalidate(self) -> None:
        """Drop every staged/pending chunk — the walk re-chunked (OOM
        backoff halved the boundary, or a committer rollback rewound it),
        so every prediction is now wrong.  Blocks until any IN-FLIGHT
        staging has finished and its buffer is released: the caller is
        typically the OOM-backoff path, and a freed staged chunk is
        exactly the device memory the halved retry needs — returning while
        the worker still holds the doomed buffer would make the retry
        re-OOM and burn a backoff level for nothing.  The wait is bounded: the
        worker sets every slot's event, including on a staging-time error
        and for cancelled-before-start requests."""
        with self._lock:
            dropped = list(self._slots.values())
            for slot in dropped:
                slot.cancelled = True
            self._invalidated += len(dropped)
            self._slots.clear()
        for slot in dropped:
            slot.event.wait()
            slot.value = None
        obs.gauge("prefetch.queue_depth").set(0)

    def close(self) -> PrefetchStats:
        """Stop the worker, drop staged chunks, and return lifetime stats."""
        if not self._closed:
            self._closed = True
            self.invalidate()
            self._q.put(_STOP)
            self._worker.join(timeout=30.0)
        return self.stats()

    def stats(self) -> PrefetchStats:
        with self._lock:
            return PrefetchStats(self._staged, self._hits, self._misses,
                                 self._staging_wall_s, self._blocked_s,
                                 self._invalidated)

"""Deterministic fault injection for the reliability layer, the data-fault
and fit-wrapper half (port of ``reliability/faultinject.py``).

Every rung of the resilience ladder must be exercisable in CPU tests — a
recovery path that only runs when a real card runs out of memory is a
recovery path that has never run.  This module provides:

**Data faults** (panel corruptions): NaN holes inside the valid span, inf
spikes, constant rows, all-NaN rows, and explosive near-collinear rows
whose float32 normal equations go indefinite (the non-SPD
Hannan-Rissanen case).  All are driven by an explicit seed and draw the
reference's positions from the reference's numpy generator, so the same
seed corrupts the same entries in both packages.  A numpy array comes back
as a new numpy array; a tensor comes back as a new tensor on its own
device, written in one scatter (a full-width panel on the card never
travels to the host).

**Behavioral faults** (fit-function wrappers): :func:`failing_fit` forces
designated rows to report non-convergence for a fixed number of fit calls
— rows are recognized by a value fingerprint, so the same row keeps
failing as the ladder gathers it into retry sub-batches —
:func:`oom_fit` raises a ``RESOURCE_EXHAUSTED``-marked error whenever the
batch exceeds a row threshold, and :func:`hanging_fit` stalls designated
fit calls past any watchdog budget.

**Commit faults** (the chunk journal): :func:`kill_after_commits` and
:func:`crash_after_commits` are journal commit hooks that SIGKILL the
process / raise :class:`SimulatedCrash` after N durable chunk commits
(between or mid commit, selectable), simulating preemption exactly where
it hurts; :func:`tear_file` truncates a manifest or shard to a prefix,
simulating a torn write on a non-atomic filesystem.

**Disk faults**: :func:`disk_fault_schedule` maps a seed to a
deterministic per-write fault sequence (EIO / ENOSPC / torn-at-fsync /
pass) and :class:`disk_faults` installs it as the journal's process-wide
disk-fault hook (:func:`~.journal.set_disk_fault_hook`), so the REAL
durable write paths fail on cue: refusals surface as ``OSError``, torn
files are rejected loudly by readers and recomputed by recovery.

**Lane faults** (the multi-lane walk): :func:`lane_kill` makes one lane's
fit calls raise :class:`SimulatedLaneFailure` (permanently or a few
times), :func:`slow_lane` makes one lane a straggler the others steal
from, and :func:`lane_oom_storm` makes every allocation of one lane fail
until it is quarantined.  All three key on
:func:`~.watchdog.current_lane`, the thread-local tag every lane of a
sharded walk carries.

**Request and server faults** (the in-process serving loop):
:func:`request_storm` bursts submits from a thread pool,
:func:`server_kill` is the serving spelling of
:func:`kill_after_commits`, and :func:`slow_tenant` straggles any batch
carrying one tenant's rows (keyed on :func:`~.watchdog.current_request`).

**Wire faults** (the fleet's socket transport):
:func:`frame_fault_schedule` maps a seed to a per-frame plan (pass / drop
/ dup / tear, the reference's draws for the same seed) and
:class:`FaultyWire` wraps a client socket to play it, with an optional
connection reset after ``reset_after`` frames
(``serving.FitClient(_wire_wrap=...)``).
"""

from __future__ import annotations

import functools
import os
import signal
import socket
import struct
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .status import STATUS_DTYPE, FitStatus
from .watchdog import current_lane, current_request

__all__ = [
    "SimulatedCrash",
    "SimulatedResourceExhausted",
    "inject_nan_rows",
    "inject_inf_rows",
    "make_constant_rows",
    "make_all_nan_rows",
    "make_explosive_rows",
    "nonspd_gram",
    "failing_fit",
    "oom_fit",
    "hanging_fit",
    "kill_after_commits",
    "crash_after_commits",
    "tear_file",
    "disk_fault_schedule",
    "disk_faults",
    "SimulatedLaneFailure",
    "lane_kill",
    "slow_lane",
    "lane_oom_storm",
    "request_storm",
    "server_kill",
    "slow_tenant",
    "frame_fault_schedule",
    "FaultyWire",
]


class SimulatedResourceExhausted(RuntimeError):
    """Stands in for an allocation failure.

    Carries the same ``RESOURCE_EXHAUSTED`` marker the reference runtime's
    error message does, so ``reliability.plan.is_resource_exhausted``
    treats it as it treats ``torch.cuda.OutOfMemoryError``.
    """

    def __init__(self, nbytes: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            f"{nbytes} bytes. (simulated by reliability.faultinject)"
        )


def _copy(y):
    """A writable copy of the panel: a tensor on its own device, else a
    numpy array of the input's dtype."""
    if isinstance(y, torch.Tensor):
        return y.clone()
    return np.array(y, dtype=np.asarray(y).dtype, copy=True)


def _scatter(out, rows, cols, values):
    """``out[rows, cols] = values`` (host index arrays) on either kind."""
    if isinstance(out, torch.Tensor):
        dev = out.device
        out[torch.as_tensor(rows, device=dev),
            torch.as_tensor(cols, device=dev)] = torch.as_tensor(
                values, dtype=out.dtype, device=dev)
    else:
        out[rows, cols] = values
    return out


def _set_rows(out, rows, values):
    """``out[rows] = values`` (a scalar, or one row a listed row)."""
    if isinstance(out, torch.Tensor):
        idx = torch.as_tensor(rows, device=out.device)
        out[idx] = torch.as_tensor(values, dtype=out.dtype, device=out.device)
    else:
        out[rows] = values
    return out


def inject_nan_rows(y, rows, frac: float = 0.2, seed: int = 0):
    """Punch NaN holes INSIDE the valid span of the given rows.

    Edge positions are kept so the holes are interior — the fault the
    sanitizer must repair, not legitimate raggedness.
    """
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    n_holes = max(1, int(frac * (t - 2)))
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    cols = np.stack([rng.choice(np.arange(1, t - 1), size=n_holes,
                                replace=False) for _ in rows])
    return _scatter(out, np.repeat(rows, n_holes), cols.ravel(), np.nan)


def inject_inf_rows(y, rows, n: int = 3, seed: int = 0):
    """Replace ``n`` interior positions of each given row with +/-inf."""
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    cols, vals = [], []
    for _ in rows:  # the reference's draw order: positions, then signs
        cols.append(rng.choice(np.arange(1, t - 1), size=n, replace=False))
        vals.append(np.where(rng.random(n) < 0.5, np.inf, -np.inf))
    return _scatter(out, np.repeat(rows, n), np.concatenate(cols),
                    np.concatenate(vals))


def make_constant_rows(y, rows, value: float = 1.0):
    """Overwrite the given rows with a constant (zero innovation variance)."""
    return _set_rows(_copy(y), np.atleast_1d(rows), value)


def make_all_nan_rows(y, rows):
    """Overwrite the given rows with NaN everywhere (nothing to fit)."""
    return _set_rows(_copy(y), np.atleast_1d(rows), np.nan)


def make_explosive_rows(y, rows, growth: float = 1.35, seed: int = 0):
    """Overwrite rows with an explosive near-collinear AR process.

    ``y_t ~= growth * y_{t-1}`` spans ~130 orders of magnitude over a 1k
    panel: in float32 the Hannan-Rissanen lag Gram matrix accumulates to
    an (effectively) indefinite / overflowed system — the non-SPD
    normal-equations fault — and CSS optimization on the row is hopeless
    within any budget, exercising the DIVERGED terminal.
    """
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    block = np.stack([(growth ** np.arange(t))
                      * (1.0 + 0.01 * rng.standard_normal(t))
                      for _ in rows])
    if not isinstance(out, torch.Tensor):
        block = block.astype(out.dtype)  # the reference's row assignment
    return _set_rows(out, rows, block)


def nonspd_gram(k: int = 4, dtype=np.float32) -> np.ndarray:
    """A deterministic symmetric matrix with one (slightly) negative
    eigenvalue — what float32 accumulation can make of a rank-deficient
    ``X^T X``.  For unit tests of ``utils.linalg.ridge_solve``'s
    non-positive-pivot fallback."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    eig = np.ones(k)
    eig[-1] = -1e-3
    return (q @ np.diag(eig) @ q.T).astype(dtype)


def _tails(y) -> np.ndarray:
    """Each row's last value as float64, read alone (a panel on the card
    sends only its last column to the host)."""
    if isinstance(y, torch.Tensor):
        return y[:, -1].cpu().numpy().astype(np.float64)
    return np.asarray(y)[:, -1].astype(np.float64)


def _fingerprints(y, rows) -> np.ndarray:
    """Identify rows by their last value (float64-exact).

    The resilient runner re-fits failed rows on the SAME (sanitized) data,
    so a row's tail value is stable across ladder rungs and sub-batch
    gathers; designated rows should be NaN-free so the sanitizer passes
    them through bit-identically.
    """
    tails = _tails(y)[np.atleast_1d(rows)]
    if np.unique(tails).size != tails.size or np.isnan(tails).any():
        raise ValueError(
            "failing_fit fingerprints must be unique, finite tail values; "
            "pick clean rows (or perturb their last sample)"
        )
    return tails


def failing_fit(fit_fn: Callable, y, rows, n_failures: int = 1) -> Callable:
    """Wrap ``fit_fn`` so the given rows of ``y`` report non-convergence.

    Each designated row fails (``converged=False``, NaN params/nll,
    ``DIVERGED`` model status) for its first ``n_failures`` fit calls that
    include it, then behaves normally — so ``n_failures=1`` drives the
    ``RETRIED`` transition, ``n_failures=2`` drives ``FALLBACK`` (with the
    default two-rung ladder), and a large value drives ``DIVERGED``.
    Budgets decrement once per CALL per row (pad rows duplicating a failed
    row do not burn extra budget).  Any other row whose last value equals
    a designated row's fails with it: pick designated rows whose tails are
    unique in the whole panel.
    """
    budgets = {fp: n_failures for fp in _fingerprints(y, rows)}

    # functools.wraps: signature introspection (the runner's per-rung
    # kwarg filtering) must see the REAL fit's signature, not (yb, **kw)
    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        res = fit_fn(yb, **kwargs)
        tails = _tails(yb)
        mask = np.zeros(tails.shape[0], bool)
        for fp in list(budgets):
            if budgets[fp] <= 0:
                continue
            hit = tails == fp
            if hit.any():
                mask |= hit
                budgets[fp] -= 1
        if not mask.any():
            return res
        m = torch.as_tensor(mask, device=res.params.device)
        params = torch.where(m[:, None], torch.nan, res.params)
        nll = torch.where(m, torch.nan, res.neg_log_likelihood)
        conv = res.converged & ~m
        status = res.status
        if status is not None:
            status = torch.where(
                m, torch.tensor(int(FitStatus.DIVERGED), dtype=torch.int8,
                                device=status.device), status
            ).to(torch.int8)
        return res._replace(
            params=params, neg_log_likelihood=nll, converged=conv,
            status=status,
        )

    return wrapped


def oom_fit(fit_fn: Callable, max_rows: int) -> Callable:
    """Wrap ``fit_fn`` to raise a simulated RESOURCE_EXHAUSTED whenever the
    batch has more than ``max_rows`` rows — a chunk driver must back off
    to at most ``max_rows`` before the fit is allowed to run."""

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        shape = np.asarray(tuple(yb.shape))
        if int(shape[0]) > max_rows:
            raise SimulatedResourceExhausted(int(shape.prod()) * 4)
        return fit_fn(yb, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# process faults (deadline watchdog, chunk journal)
# ---------------------------------------------------------------------------


class SimulatedCrash(BaseException):
    """In-process stand-in for a SIGKILL: derives from ``BaseException`` so
    no ``except Exception`` recovery path can accidentally swallow it — a
    journaled driver must survive by durability, not by catching it."""


def hanging_fit(fit_fn: Callable, hang_calls, sleep_s: float = 30.0) -> Callable:
    """Wrap ``fit_fn`` so the given (0-based) call indices stall ``sleep_s``
    before fitting — a stand-in for a hung kernel build or pathological
    optimizer tail.  Under ``watchdog.call_with_deadline`` with a budget
    below ``sleep_s`` the caller gets ``DeadlineExceeded``; the abandoned
    worker thread wakes later, runs the real fit, and its result is
    discarded."""
    hang = set(int(i) for i in np.atleast_1d(hang_calls))
    state = {"calls": 0}

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        i = state["calls"]
        state["calls"] += 1
        if i in hang:
            time.sleep(sleep_s)
        return fit_fn(yb, **kwargs)

    return wrapped


def kill_after_commits(n: int, *, mid_commit: bool = False) -> Callable:
    """Journal commit hook that SIGKILLs THIS process after ``n`` chunks
    have been made durable — no atexit, no cleanup, exactly like a
    preemption.  ``mid_commit=True`` kills after the nth shard is written
    but BEFORE the manifest names it (the orphan-shard window the
    write-ahead ordering must make recoverable); otherwise the kill lands
    after the manifest update (between chunks).  Pass as
    ``fit_chunked(..., _journal_commit_hook=...)`` in a subprocess.
    """
    event = "shard_written" if mid_commit else "committed"
    seen = {"n": 0}
    mu = threading.Lock()  # a sharded walk's lanes commit concurrently

    def hook(ev: str, lo: int) -> None:
        if ev != event:
            return
        with mu:
            seen["n"] += 1
            hit = seen["n"] >= n
        if hit:
            os.kill(os.getpid(), signal.SIGKILL)

    return hook


def crash_after_commits(n: int, *, mid_commit: bool = False) -> Callable:
    """Like :func:`kill_after_commits` but raises :class:`SimulatedCrash`
    instead of dying — the in-process variant for tests that want to crash
    and resume inside one interpreter (same journal state on disk, no
    subprocess round trip)."""
    event = "shard_written" if mid_commit else "committed"
    seen = {"n": 0}
    mu = threading.Lock()  # a sharded walk's lanes commit concurrently

    def hook(ev: str, lo: int) -> None:
        if ev != event:
            return
        with mu:
            seen["n"] += 1
            hit = seen["n"] >= n
        if hit:
            raise SimulatedCrash(
                f"simulated process death after {n} {event} events")

    return hook


def tear_file(path: str, keep_frac: float = 0.5) -> None:
    """Truncate ``path`` to a prefix, simulating a torn write (a crash on a
    filesystem without atomic replace, or a partially flushed page).  Torn
    manifests must be REJECTED on resume (``TornManifestError``), torn
    shards silently downgraded to a recompute."""
    size = os.path.getsize(path)
    keep = max(1, int(size * keep_frac))
    with open(path, "r+b") as f:
        f.truncate(keep)


# ---------------------------------------------------------------------------
# disk faults (the durable write paths themselves fail)
# ---------------------------------------------------------------------------


def disk_fault_schedule(seed: int, n: int, *, eio_frac: float = 0.05,
                        enospc_frac: float = 0.05,
                        torn_frac: float = 0.05) -> list:
    """A deterministic per-write disk-fault plan: ``n`` entries drawn
    from ``{"pass", "eio", "enospc", "torn"}`` with the given rates, from
    the reference's numpy generator (the same seed gives the same plan in
    both packages).  ``eio`` and ``enospc`` refuse the write before any
    bytes land; ``torn`` lets the replace land then truncates the file (a
    lying fsync — readers must reject the bytes loudly, recovery must
    recompute)."""
    if eio_frac + enospc_frac + torn_frac > 1.0:
        raise ValueError("fault fractions must sum to at most 1.0")
    rng = np.random.default_rng(int(seed))
    u = rng.random(int(n))
    out = []
    for x in u:
        if x < eio_frac:
            out.append("eio")
        elif x < eio_frac + enospc_frac:
            out.append("enospc")
        elif x < eio_frac + enospc_frac + torn_frac:
            out.append("torn")
        else:
            out.append("pass")
    return out


class disk_faults:
    """Context manager installing a :func:`disk_fault_schedule` as the
    process-wide journal disk-fault hook
    (:func:`~.journal.set_disk_fault_hook`).

    Each GUARDED durable write — journal shards and manifests, input and
    output shards (``kind="durable"``), and the serving layer's
    ``write_ahead`` / ``result`` kinds once it is ported — consumes the
    next schedule entry; past the end every write passes (faults are a
    finite storm, not a dead disk).  ``kinds`` restricts the fault to a
    write class and ``path_substr`` to matching paths; filtered-out writes
    pass WITHOUT consuming schedule entries, so a schedule's shape is
    independent of unrelated background writes.  ``log`` records ``(kind,
    path, verdict)`` per faulted consult.

    Concurrent durable writers (the driver, the committer thread, a sink
    writer) all consult the one installed hook; the schedule cursor and
    the fault log advance under a lock so each entry is consumed exactly
    once.
    """

    _protected_by_ = {
        "_i": "_lock",
        "log": "_lock",
    }

    def __init__(self, schedule, *, kinds: Optional[tuple] = None,
                 path_substr: Optional[str] = None):
        self._schedule = list(schedule)
        self._kinds = None if kinds is None else tuple(kinds)
        self._path_substr = path_substr
        self._i = 0
        self._lock = threading.Lock()
        self._prev = None
        self.log: list = []

    def _hook(self, path: str, kind: str) -> str:
        if self._kinds is not None and kind not in self._kinds:
            return "pass"
        if self._path_substr is not None and self._path_substr not in path:
            return "pass"
        with self._lock:
            i = self._i
            self._i += 1
            verdict = (self._schedule[i] if i < len(self._schedule)
                       else "pass")
            if verdict != "pass":
                self.log.append((kind, path, verdict))
        return verdict

    def __enter__(self) -> "disk_faults":
        from . import journal

        self._prev = journal.set_disk_fault_hook(self._hook)
        return self

    def __exit__(self, *exc) -> None:
        from . import journal

        journal.set_disk_fault_hook(self._prev)


# ---------------------------------------------------------------------------
# lane faults (the multi-lane walk: quarantine and rebalance)
# ---------------------------------------------------------------------------


class SimulatedLaneFailure(RuntimeError):
    """Stands in for a dead lane device: an exception no backoff ladder can
    absorb (not an allocation failure, not a watchdog timeout), so the
    elastic supervisor's retry → quarantine path is the only recovery."""

    def __init__(self, shard_id: int):
        super().__init__(
            f"lane shard={shard_id} failed "
            "(simulated by reliability.faultinject.lane_kill)")
        self.shard_id = int(shard_id)


def lane_kill(fit_fn: Callable, shard_id: int, after_chunks: int = 0,
              n_failures: Optional[int] = None) -> Callable:
    """Wrap ``fit_fn`` so lane ``shard_id``'s fit calls raise
    :class:`SimulatedLaneFailure` after ``after_chunks`` successful calls.

    ``n_failures=None`` (default) is a PERMANENT death — every later call
    on that lane fails too, so the supervisor's retries burn out and the
    lane is quarantined, its span reassigned to survivors.  An integer
    makes the fault TRANSIENT (the lane recovers after that many
    failures), exercising the retry-without-quarantine path.  Calls from
    other lanes (or outside any lane) pass through untouched.
    """
    state = {"ok": 0, "failed": 0}

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        if current_lane() == int(shard_id):
            if state["ok"] >= int(after_chunks) and (
                    n_failures is None or state["failed"] < int(n_failures)):
                state["failed"] += 1
                raise SimulatedLaneFailure(int(shard_id))
            state["ok"] += 1
        return fit_fn(yb, **kwargs)

    return wrapped


def slow_lane(fit_fn: Callable, shard_id: int, delay_s: float) -> Callable:
    """Wrap ``fit_fn`` so lane ``shard_id`` stalls ``delay_s`` before every
    fit call — a deterministic straggler device.  The elastic walk's idle
    survivors should STEAL the straggler's unstarted chunks once its
    projected finish blows the rebalance threshold; the fault follows the
    LANE, so stolen chunks run at full speed on their new lane."""

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        if current_lane() == int(shard_id):
            time.sleep(float(delay_s))
        return fit_fn(yb, **kwargs)

    return wrapped


def lane_oom_storm(fit_fn: Callable, shard_id: int) -> Callable:
    """Wrap ``fit_fn`` so every fit call on lane ``shard_id`` raises a
    simulated ``RESOURCE_EXHAUSTED`` — an allocator storm no chunk halving
    survives.  The lane's backoff ladder exhausts
    (``OOMBackoffExceeded``), its retries re-exhaust, and the elastic
    supervisor quarantines it; survivors recompute its chunks at their own
    (healthy) chunk size.  Only that lane backs off: the others never see
    the fault."""

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        if current_lane() == int(shard_id):
            raise SimulatedResourceExhausted(
                int(np.prod(np.asarray(tuple(yb.shape)))) * 4)
        return fit_fn(yb, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# request faults (the resident fit server's admission, deadline, shedding
# and crash-recovery paths, exercisable in CPU tests)
# ---------------------------------------------------------------------------


def request_storm(submit: Callable, calls, threads: int = 8,
                  timeout_s: float = 120.0) -> tuple:
    """Burst-admit ``calls`` concurrently — the admission-control load
    test.  ``submit`` is typically ``server.submit``; each element of
    ``calls`` is ``(args_tuple, kwargs_dict)`` and is fired from a pool
    of ``threads`` worker threads as fast as they can go.

    Returns ``(results, errors)``, both lists aligned with ``calls``:
    ``results[i]`` is the submit's return value (a ticket) or None,
    ``errors[i]`` the exception it raised (``RejectedError`` under
    overload — the storm is exactly how shedding is driven) or None.
    Deterministic in coverage, deliberately NOT in interleaving: the
    invariant under test is conservation (every call is answered or
    explicitly rejected; none hang, none OOM), not ordering.
    """
    import queue as queue_mod

    calls = list(calls)
    results: list = [None] * len(calls)
    errors: list = [None] * len(calls)
    work: "queue_mod.Queue" = queue_mod.Queue()
    for i, c in enumerate(calls):
        work.put((i, c))

    def _worker():
        while True:
            try:
                i, (args, kwargs) = work.get_nowait()
            except queue_mod.Empty:
                return
            try:
                results[i] = submit(*args, **(kwargs or {}))
            except BaseException as e:  # noqa: BLE001 - reported per call
                errors[i] = e

    ts = [threading.Thread(target=_worker, daemon=True,
                           name=f"request-storm-{k}")
          for k in range(max(1, int(threads)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=timeout_s)
    return results, errors


def server_kill(n_commits: int, *, mid_commit: bool = False) -> Callable:
    """SIGKILL stand-in for a dying fit SERVER: a journal commit hook that
    kills the process after ``n_commits`` durable chunk commits COUNTED
    ACROSS every batch walk the server runs (pass as
    ``FitServer(_commit_hook=...)`` in a subprocess).  With
    ``mid_commit=True`` the kill lands inside a commit (shard written,
    manifest not yet updated) — the torn-batch window restart recovery
    must replay.  Same contract as :func:`kill_after_commits`."""
    return kill_after_commits(n_commits, mid_commit=mid_commit)


def slow_tenant(fit_fn: Callable, tenant: str, delay_s: float) -> Callable:
    """Wrap ``fit_fn`` so any serving batch carrying ``tenant``'s rows
    straggles ``delay_s`` per fit call — one tenant's pathological panel
    slowing the micro-batch it rides in.  Keys on the thread-local
    request tag (:func:`~.watchdog.current_request`), so the SAME
    registered fit behaves normally for every other batch; with a
    chunk/job budget armed the watchdog TIMEOUTs the straggling batch
    instead of hanging the server."""

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        tags = current_request() or ()
        if tenant in tags:
            time.sleep(float(delay_s))
        return fit_fn(yb, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# transport faults (the fleet's socket plane: dropped / duplicated /
# half-written frames and connection resets, deterministically seeded)
# ---------------------------------------------------------------------------


def frame_fault_schedule(seed: int, n: int, *, drop_frac: float = 0.1,
                         dup_frac: float = 0.1,
                         tear_frac: float = 0.05) -> list:
    """A deterministic per-frame fault plan: ``n`` entries drawn from
    ``{"pass", "drop", "dup", "tear"}`` with the given rates.  Same seed
    → same schedule, bit for bit (numpy's ``default_rng``, as the
    reference draws it), so a transport test's fault pattern is
    reproducible from its seed alone (the client's backoff jitter is
    seeded the same way — :func:`serving.client.backoff_schedule`)."""
    if drop_frac + dup_frac + tear_frac > 1.0:
        raise ValueError("fault fractions must sum to at most 1.0")
    rng = np.random.default_rng(int(seed))
    u = rng.random(int(n))
    out = []
    for x in u:
        if x < drop_frac:
            out.append("drop")
        elif x < drop_frac + dup_frac:
            out.append("dup")
        elif x < drop_frac + dup_frac + tear_frac:
            out.append("tear")
        else:
            out.append("pass")
    return out


class FaultyWire:
    """A lossy socket: each ``sendall`` (one wire frame, by the transport
    layer's one-``sendall``-per-message contract) consumes the next entry
    of a :func:`frame_fault_schedule` — ``pass`` forwards the frame,
    ``drop`` swallows it (the peer never sees it; the client's deadline +
    resubmit machinery must recover), ``dup`` forwards it twice (the
    server must ack idempotently and the client must pair replies by
    msg id), ``tear`` forwards a half-frame prefix then resets the
    connection (the peer's CRC/EOF validation must reject the torn frame
    loudly).  ``reset_after=k`` additionally drops the connection after
    ``k`` successful frames — the mid-batch reset fault.  Past the end of
    the schedule every frame passes (faults are a finite storm, not a
    dead wire).  Duck-types the socket surface the transport layer uses
    (``sendall/recv/settimeout/close``); wrap client connections via
    ``FitClient(_wire_wrap=...)``."""

    def __init__(self, sock, schedule, *, reset_after: Optional[int] = None):
        self._sock = sock
        self._schedule = list(schedule)
        self._sent = 0
        self._ok = 0
        self._reset_after = None if reset_after is None else int(reset_after)
        self.log: list = []

    def _next_fault(self) -> str:
        i = self._sent
        self._sent += 1
        if self._reset_after is not None and self._ok >= self._reset_after:
            return "reset"
        return self._schedule[i] if i < len(self._schedule) else "pass"

    def sendall(self, data: bytes) -> None:
        fault = self._next_fault()
        self.log.append(fault)
        if fault == "drop":
            return
        if fault == "dup":
            self._sock.sendall(data)
            self._sock.sendall(data)
            self._ok += 1
            return
        if fault == "tear":
            self._sock.sendall(data[: max(1, len(data) // 2)])
            self._reset()
            raise ConnectionResetError(
                "simulated torn frame (reliability.faultinject.FaultyWire)")
        if fault == "reset":
            self._reset()
            raise ConnectionResetError(
                "simulated connection reset "
                "(reliability.faultinject.FaultyWire)")
        self._sock.sendall(data)
        self._ok += 1

    def _reset(self) -> None:
        try:
            # SO_LINGER 0: RST on close, not FIN — an abrupt peer death
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    def recv(self, n: int) -> bytes:
        return self._sock.recv(n)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

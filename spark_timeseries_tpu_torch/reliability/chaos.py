"""Seeded chaos orchestration + invariant checking (port of
``reliability/chaos.py``).

:mod:`.faultinject` provides the PRIMITIVES — SIGKILL-after-commits,
lossy wires, disk faults — each deterministic in isolation.  This module
composes them into timed SCENARIOS against a live fleet and states what
must survive them:

- :func:`chaos_schedule` — a seeded list of :class:`ChaosEvent`\\ s (kill
  the primary at t=1.2s, arm disk faults on a standby at t=2.0s, …):
  the same seed replays the same scenario in every process, so a chaos
  run that finds a bug IS its reproducer.
- :class:`ChaosRunner` — walks a schedule against caller-supplied
  handlers on a background thread while the caller storms the fleet.
  Execution is wall-clock (sleeping to each event's offset); the
  *decisions* — what fires, in what order, with what parameters — are
  all in the seeded schedule.
- :func:`check_invariants` — the contract a degraded fleet must still
  honor, as data: **conservation** (every admitted request answered
  exactly once — zero lost, zero duplicated), **bitwise re-answers**
  (a re-polled result is byte-identical to its first answer),
  **monotonic fencing** (lease tokens only ever increase; no two
  holders overlap), and **bounded unavailability** (the longest window
  with zero successful probes stays under the bound).  Returns the
  violations; an empty list is the pass.
- :func:`write_chaos_manifest` — the scenario's durable record
  (schedule, probe timeline, invariant verdicts, counters) written
  atomically at the fleet root, the same bytes as the reference's.
- :func:`join_injections` — the manifest's injections joined to their
  observed consequences in the merged fleet event timeline (injection
  -> victim's last heartbeat -> survivor's election -> takeover
  latency).

The orchestration of real replicas (subprocesses, handlers that SIGKILL
or pause them) belongs to the caller; this module is the library it
drives.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, \
    Tuple

import numpy as np

from .journal import _atomic_write_bytes
from .runner import _host

__all__ = [
    "CHAOS_KINDS",
    "ChaosEvent",
    "ChaosRunner",
    "InvariantViolation",
    "chaos_schedule",
    "check_invariants",
    "join_injections",
    "load_chaos_manifest",
    "unavailability_windows",
    "write_chaos_manifest",
]

CHAOS_MANIFEST = "chaos_manifest.json"

# the composable fault kinds a schedule draws from; handlers interpret
# the target/params (the library does not know what "kill" means for a
# given deployment — subprocess SIGKILL, in-process crash hook, …)
CHAOS_KINDS = ("kill", "disk", "frames", "pause")

RESULT_FIELDS = ("params", "neg_log_likelihood", "converged", "iters",
                 "status")


class ChaosEvent(NamedTuple):
    """One timed fault: ``t_s`` after scenario start, a ``kind`` from
    :data:`CHAOS_KINDS`, a ``target`` role/owner string, and kind-
    specific ``params`` (all JSON-serializable — the event list IS the
    manifest's scenario record)."""

    t_s: float
    kind: str
    target: str
    params: dict


def chaos_schedule(seed: int, duration_s: float, *,
                   n_events: int = 4,
                   kinds: Sequence[str] = ("kill", "disk", "frames"),
                   targets: Sequence[str] = ("primary", "standby"),
                   ) -> List[ChaosEvent]:
    """A seeded scenario: ``n_events`` faults at sorted offsets inside
    ``(0.1, duration_s)``.  Kind-specific parameters derive from the
    same generator, so the whole scenario — timing, victims, fault
    intensities — replays from one integer."""
    for k in kinds:
        if k not in CHAOS_KINDS:
            raise ValueError(f"unknown chaos kind {k!r} "
                             f"(have {CHAOS_KINDS})")
    if not targets:
        raise ValueError("chaos_schedule needs >= 1 target")
    rng = np.random.default_rng(int(seed))
    n = int(n_events)
    times = np.sort(rng.uniform(0.1, max(0.2, float(duration_s)), size=n))
    out: List[ChaosEvent] = []
    for i in range(n):
        kind = str(kinds[int(rng.integers(0, len(kinds)))])
        target = str(targets[int(rng.integers(0, len(targets)))])
        params: dict = {}
        if kind == "kill":
            # victims die after 1..3 further durable commits, so the
            # kill lands mid-protocol, not between requests
            params = {"after_commits": int(rng.integers(1, 4))}
        elif kind == "disk":
            params = {
                "fault_seed": int(rng.integers(0, 2 ** 31 - 1)),
                "n": 32,
                "eio_frac": round(float(rng.uniform(0.05, 0.2)), 3),
                "torn_frac": round(float(rng.uniform(0.05, 0.2)), 3),
            }
        elif kind == "frames":
            params = {
                "fault_seed": int(rng.integers(0, 2 ** 31 - 1)),
                "drop_frac": round(float(rng.uniform(0.02, 0.1)), 3),
                "reset_frac": round(float(rng.uniform(0.02, 0.1)), 3),
            }
        elif kind == "pause":
            params = {"pause_s": round(float(rng.uniform(0.1, 0.5)), 3)}
        out.append(ChaosEvent(round(float(times[i]), 3), kind, target,
                              params))
    return out


class ChaosRunner:
    """Executes a schedule against caller handlers on a daemon thread.

    ``handlers`` maps each kind appearing in the schedule to a callable
    taking the :class:`ChaosEvent`; a handler that raises marks the
    event errored (recorded, never re-raised — chaos must not kill the
    orchestrator) and the run continues.

    .. attribute:: _protected_by_

        Lock-discipline contract (the lint lock map): the runner
        thread appends fired/errored records while the orchestrator
        thread reads them mid-storm and joins at the end.
    """

    _protected_by_ = {
        "_fired": "_lock",
        "_errors": "_lock",
    }

    def __init__(self, schedule: Sequence[ChaosEvent],
                 handlers: Dict[str, Callable[[ChaosEvent], None]]):
        self.schedule = sorted(schedule, key=lambda e: e.t_s)
        missing = {e.kind for e in self.schedule} - set(handlers)
        if missing:
            raise ValueError(
                f"schedule uses kinds with no handler: {sorted(missing)}")
        self.handlers = dict(handlers)
        self._lock = threading.Lock()
        self._fired: List[dict] = []
        self._errors: List[dict] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ChaosRunner":
        if self._thread is not None:
            raise RuntimeError("ChaosRunner.start() called twice")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="chaos-runner")
        self._thread.start()
        return self

    def _run(self) -> None:
        t0 = time.monotonic()
        for ev in self.schedule:
            delay = ev.t_s - (time.monotonic() - t0)
            if delay > 0 and self._stop.wait(delay):
                return
            if self._stop.is_set():
                return
            rec = {"t_s": ev.t_s, "kind": ev.kind, "target": ev.target,
                   "params": ev.params,
                   "fired_at_s": round(time.monotonic() - t0, 3)}
            try:
                self.handlers[ev.kind](ev)
            except Exception as e:  # noqa: BLE001 - chaos never kills
                # the orchestrator; the record is the diagnosis
                with self._lock:
                    self._errors.append({**rec, "error": repr(e)[:300]})
            else:
                with self._lock:
                    self._fired.append(rec)

    def join(self, timeout_s: float = 60.0) -> Tuple[List[dict],
                                                     List[dict]]:
        """Wait for the schedule to finish; returns (fired, errors)."""
        t = self._thread
        if t is not None:
            t.join(timeout=timeout_s)
        with self._lock:
            return list(self._fired), list(self._errors)

    def stop(self) -> None:
        self._stop.set()


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


class InvariantViolation(NamedTuple):
    invariant: str  # conservation | bitwise | fencing | availability
    detail: str


def _result_fields(res) -> dict:
    """A result's fields as host arrays (a tensor field, on any device,
    read to the host once)."""
    return {f: _host(getattr(res, f)) for f in RESULT_FIELDS
            if hasattr(res, f)}


def unavailability_windows(probes: Sequence[Tuple[float, bool]]
                           ) -> List[Tuple[float, float]]:
    """Contiguous ``(start, end)`` windows with zero successful probes,
    from a ``(t, ok)`` timeline (t monotonic-relative seconds).  A
    window opens at the first failed probe after a success and closes
    at the next success; a trailing failure run closes at the last
    probe's time."""
    out: List[Tuple[float, float]] = []
    start: Optional[float] = None
    last_t = None
    for t, ok in sorted(probes):
        last_t = t
        if ok:
            if start is not None:
                out.append((start, t))
                start = None
        elif start is None:
            start = t
    if start is not None and last_t is not None and last_t > start:
        out.append((start, last_t))
    elif start is not None:
        out.append((start, start))
    return out


def check_invariants(*, expected_ids: Optional[Sequence[str]] = None,
                     answers: Optional[dict] = None,
                     reanswers: Optional[dict] = None,
                     lease_history: Optional[Sequence[dict]] = None,
                     probes: Optional[Sequence[Tuple[float, bool]]] = None,
                     max_unavailable_s: Optional[float] = None,
                     ) -> List[InvariantViolation]:
    """The degraded-fleet contract, checked over collected evidence
    (every argument optional — pass what the scenario gathered):

    - ``expected_ids`` + ``answers``: conservation — every admitted id
      has exactly one answer (``answers`` values may be result objects
      or None for a lost answer).
    - ``answers`` + ``reanswers``: bitwise — a re-polled id's fields
      equal its first answer's byte for byte.
    - ``lease_history``: fencing — token sequence strictly increases
      (each dict needs ``token``; equal-token repeats of the SAME owner
      are heartbeats and fine).
    - ``probes`` + ``max_unavailable_s``: bounded unavailability.
    """
    out: List[InvariantViolation] = []
    if expected_ids is not None and answers is not None:
        for rid in expected_ids:
            if answers.get(rid) is None:
                out.append(InvariantViolation(
                    "conservation", f"request {rid!r} was admitted but "
                    "never answered (lost)"))
        extra = set(answers) - set(expected_ids)
        if extra:
            out.append(InvariantViolation(
                "conservation", f"answers for ids never admitted: "
                f"{sorted(extra)[:5]}"))
    if answers is not None and reanswers is not None:
        for rid, re_res in reanswers.items():
            first = answers.get(rid)
            if first is None or re_res is None:
                continue  # conservation covers the missing side
            a, b = _result_fields(first), _result_fields(re_res)
            for f in a:
                if not np.array_equal(a[f], b.get(f), equal_nan=True):
                    out.append(InvariantViolation(
                        "bitwise", f"request {rid!r} field {f} differs "
                        "on re-answer — the durable result is not the "
                        "answer of record"))
                    break
    if lease_history:
        prev_tok, prev_owner = None, None
        for rec in lease_history:
            tok, owner = rec.get("token"), rec.get("owner")
            if tok is None:
                continue
            if prev_tok is not None and tok < prev_tok:
                out.append(InvariantViolation(
                    "fencing", f"lease token regressed {prev_tok} -> "
                    f"{tok} (owner {owner!r})"))
            elif (prev_tok is not None and tok == prev_tok
                    and owner != prev_owner):
                out.append(InvariantViolation(
                    "fencing", f"two owners ({prev_owner!r}, {owner!r}) "
                    f"share token {tok}"))
            prev_tok, prev_owner = tok, owner
    if probes is not None and max_unavailable_s is not None:
        for start, end in unavailability_windows(probes):
            if end - start > float(max_unavailable_s):
                out.append(InvariantViolation(
                    "availability", f"fleet unavailable for "
                    f"{end - start:.2f}s (bound "
                    f"{float(max_unavailable_s):.2f}s) from t={start:.2f}"))
    return out


def join_injections(fired: Sequence[dict],
                    events: Sequence[dict]) -> List[dict]:
    """Join the manifest's ``kill`` injections to their observed fleet
    consequences, from recorder evidence alone.

    ``fired`` is the chaos manifest's fired-injection list (each record
    carries at least ``kind``; kills are the ones joined).  ``events``
    is the merged fleet event timeline: recorder event lines as dicts,
    each carrying its recorder ``ts`` and tagged by the caller with the
    ``stream`` it came from (the replica owner, or ``"client"``).

    Injection offsets (monotonic, scenario-relative) and recorder
    timestamps (wall clock) share no common zero, so the join is
    ORDINAL: the N-th kill pairs with the N-th ownership CHANGE — a
    ``fleet.elected`` naming a different owner than the previous
    holder (the fleet's initial election is not a consequence).  Each
    consequence record names the victim and survivor, the victim
    stream's last event before the takeover, and the takeover latency
    (survivor's election ts minus the victim's last ts — a wall-clock
    delta across same-host replica processes, so a clock offset between
    them shows in it).  A kill with no matching
    election reports ``observed=False`` (e.g. the handler declined to
    fire because the fleet was already down to one replica).

    Pure function: no clocks, no I/O — callers feed it loaded streams.
    """
    def _attr(e: dict, key: str):
        # recorder event lines nest attributes under "attrs"; accept
        # pre-flattened dicts too so callers need not reshape
        return e[key] if key in e else (e.get("attrs") or {}).get(key)

    kills = [r for r in fired if r.get("kind") == "kill"]
    elected = sorted(
        (e for e in events
         if e.get("name") == "fleet.elected" and e.get("ts") is not None),
        key=lambda e: float(e["ts"]))
    changes: List[Tuple[str, dict]] = []
    holder: Optional[str] = None
    for e in elected:
        who = _attr(e, "owner")
        if holder is not None and who != holder:
            changes.append((holder, e))
        holder = who
    out: List[dict] = []
    for i, kill in enumerate(kills):
        rec: dict = {"injection": dict(kill), "observed": i < len(changes)}
        if i < len(changes):
            victim, e = changes[i]
            t_elect = float(e["ts"])
            last = max((float(v["ts"]) for v in events
                        if v.get("stream") == victim
                        and v.get("ts") is not None
                        and float(v["ts"]) <= t_elect), default=None)
            rec.update({
                "victim": victim,
                "survivor": _attr(e, "owner"),
                "elected_token": _attr(e, "token"),
                "victim_last_ts": last,
                "takeover_latency_s": (None if last is None
                                       else round(t_elect - last, 3)),
            })
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# the durable scenario record
# ---------------------------------------------------------------------------


def write_chaos_manifest(root: str, manifest: dict) -> str:
    """Atomically write the scenario record (``chaos_manifest.json``)
    at the fleet root — schedule, probe timeline, invariant verdicts,
    counters — for post-mortems."""
    path = os.path.join(os.path.abspath(root), CHAOS_MANIFEST)
    payload = (json.dumps(manifest, sort_keys=True, indent=1,
                          default=repr) + "\n").encode()
    _atomic_write_bytes(path, payload)
    return path


def load_chaos_manifest(root: str) -> dict:
    path = os.path.join(os.path.abspath(root), CHAOS_MANIFEST)
    with open(path, encoding="utf-8") as f:
        return json.load(f)

"""Lease-fenced FitServer replicas sharing one checkpoint root (port of
``serving/fleet.py``).

The durable story under ``<root>`` (write-ahead requests, batch
journals, results) is a single-writer protocol, so
a fleet of N replicas must elect exactly one writer — and keep a
SIGKILLed writer's ZOMBIE (the same process restarted, or a stalled
thread waking up mid-write) from ever splicing bytes over its
successor's.  Both come from ``reliability.journal``'s lease records:

- a replica becomes **primary** by winning :func:`~..reliability.journal.
  acquire_lease` (an ``O_EXCL`` claim manifest allocates a strictly
  monotonic fencing token); it then constructs a :class:`~.server.
  FitServer` on the shared root — whose normal crash RECOVERY is what
  re-answers the dead peer's write-ahead requests, bitwise — and
  heartbeats the lease while serving.
- every durable write the primary performs is **fenced**: the journal
  commit hook and the result store both re-check the token first, so a
  stale holder dies with :class:`~..reliability.journal.FencedError`
  mid-write instead of corrupting the root (stale-token writers lose
  loudly).
- **standbys** poll the lease and serve the transport meanwhile:
  submits answer ``not_leader`` (the client rotates and retries), but
  result polls are answered FROM THE DURABLE FILES — a completed
  request's result is readable through any replica, which is what makes
  client polling survive the primary's death without waiting out the
  lease TTL.

The standby story widens from "polls only" into a degradation
LADDER (full → read_only → storage_degraded → fenced):

- **standby reads**: a standby also answers ``submit_forecast`` — a
  forecast derives from the request's own params with a content-derived
  interval seed, so ANY replica computes it bitwise-identically; the
  standby runs the walk on a private per-owner scratch root
  (``<root>/standby_scratch/<owner>``) that never touches the
  single-writer namespaces, answering straight from the shared durable
  results when the id was already answered.  During a LEADERLESS window
  plain submits degrade from ``not_leader`` ("retry elsewhere") to the
  typed ``read_only`` ("retry later — an election is in flight") while
  reads keep flowing.
- **storage-fault tolerance**: a primary whose root refuses writes —
  write-ahead refused at admission (typed ``storage_degraded``
  backpressure, see :class:`~.session.StorageError`), a heartbeat that
  cannot land, a result store that dies with ``OSError`` — steps DOWN
  cleanly through the fence instead of crashing opaque, then sits out
  elections for a cooldown while its disk is suspect (reads still
  served).  A torn stored result is discarded and downgraded to
  recompute-or-redirect, never served.

Topology: every replica runs its own :class:`~.transport.TransportServer`
and advertises its endpoint under ``<root>/endpoints/`` so clients can
discover the fleet from the root alone.

Device: a replica takes no ``device=`` of its own.  The device rides
``server_kwargs`` to the :class:`~.server.FitServer` a primary builds
(default ``"cuda"``), and to the standby's scratch server, so one
process holds at most two servers on its card.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from .. import obs
from ..reliability import journal as journal_mod
from ..reliability.journal import FencedError
from . import transport as transport_mod
from .server import FitServer
from .session import FitTicket, TenantFitResult
from .transport import NotLeaderError, TransportServer

__all__ = [
    "FleetReplica",
    "advertise_endpoint",
    "discover_endpoints",
    "withdraw_endpoint",
]

ENDPOINTS_DIR = "endpoints"
SCRATCH_DIR = "standby_scratch"

# the degradation ladder, as the `fleet.state` gauge spells it (rising
# numbers = rising degradation; dashboards alert on a raw threshold)
STATE_CODES = {
    "full": 0,          # primary, serving writes and reads
    "recovering": 1,    # primary-elect replaying the dead peer's queue
    "standby": 2,       # a live leader exists elsewhere; reads served here
    "read_only": 3,     # leaderless window: reads only, writes wait
    "storage_degraded": 4,  # this replica's disk is suspect; sitting out
    "retired": 5,
    "stopped": 6,
}


# ---------------------------------------------------------------------------
# endpoint advertisement (fleet discovery from the root alone)
# ---------------------------------------------------------------------------


def advertise_endpoint(root: str, owner: str, host: str, port: int) -> None:
    """Durably advertise a replica's transport endpoint under the root
    (atomic: a discovering client never reads a torn advert)."""
    d = os.path.join(os.path.abspath(root), ENDPOINTS_DIR)
    os.makedirs(d, exist_ok=True)
    journal_mod._atomic_write_bytes(
        os.path.join(d, f"{owner}.json"),
        (json.dumps({"owner": str(owner), "host": str(host),
                     "port": int(port), "pid": os.getpid()},
                    sort_keys=True) + "\n").encode())


def withdraw_endpoint(root: str, owner: str) -> None:
    try:
        os.remove(os.path.join(os.path.abspath(root), ENDPOINTS_DIR,
                               f"{owner}.json"))
    except OSError:
        pass


def discover_endpoints(root: str) -> List[Tuple[str, int]]:
    """Every advertised ``(host, port)`` under the root, owner-sorted.
    Stale adverts (a SIGKILLed replica never withdraws) are harmless:
    clients treat a refused connection as one more rotate-and-retry."""
    d = os.path.join(os.path.abspath(root), ENDPOINTS_DIR)
    out = []
    try:
        names = sorted(os.listdir(d))
    except OSError:
        return out
    for fn in names:
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(d, fn)) as f:
                rec = json.load(f)
            out.append((str(rec["host"]), int(rec["port"])))
        except (OSError, json.JSONDecodeError, KeyError, ValueError):
            continue
    return out


def _load_result_file(path: str) -> TenantFitResult:
    """A stored result, loaded WITHOUT a server instance (the standby
    poll path): same npz spelling as ``FitServer._store_result``."""
    with open(path, "rb") as f:
        return transport_mod.decode_result_blob(f.read())


# ---------------------------------------------------------------------------
# the fenced server: every durable write re-checks the token first
# ---------------------------------------------------------------------------


class _FencedFitServer(FitServer):
    """A FitServer whose durable writes are gated by a fleet lease.

    Two fences cover every byte the server lands on the shared root:
    the journal commit hook (checked at each durable chunk commit, so a
    zombie's batch walk dies mid-batch) and the result store (so a walk
    that finished before the fence flipped still cannot splice its
    result file over the new primary's).  Both raise
    :class:`FencedError` — the crash path, not a degrade."""

    def __init__(self, root: str, lease: journal_mod.Lease, **kwargs):
        self._fleet_lease = lease
        user_hook = kwargs.pop("_commit_hook", None)

        def fenced_hook(event: str, lo: int) -> None:
            if event == "committed":
                lease.check()
            if user_hook is not None:
                user_hook(event, lo)

        super().__init__(root, _commit_hook=fenced_hook, **kwargs)
        # third fence: tenant profiles are warm-start state on
        # the SHARED root — a zombie's late profile write would poison
        # the survivor's routing, so it obeys the same token discipline
        self.profiles.fence = lease.check

    def _store_result(self, req_id: str, res) -> None:
        self._fleet_lease.check()
        super()._store_result(req_id, res)


# ---------------------------------------------------------------------------
# the replica
# ---------------------------------------------------------------------------


class FleetReplica:
    """One member of a FitServer fleet on a shared checkpoint root.

    .. attribute:: _protected_by_

        Lock-discipline contract (the lint lock map): the control
        thread elects/demotes while transport handler threads read the
        role and delegate to the leased server, and ``stop()`` may come
        from any thread — the role/lease/server triple and the counters
        mutate only under their locks.

    Lifecycle: ``start()`` brings up the transport (standbys answer),
    advertises the endpoint, and runs the control thread — a loop of
    ``acquire_lease`` → serve-as-primary (heartbeating every ``ttl/3``)
    → demote on crash/fence/stop.  ``server_kwargs`` configure the
    FitServer a primary constructs (fault hooks ride ``_commit_hook``
    exactly as on a standalone server).  ``retire_on_crash=True`` keeps
    a crashed replica down instead of re-electing it — what the
    deterministic failover tests use to pin WHO takes over.
    """

    _protected_by_ = {
        "_server": "_state_lock",
        "_lease": "_state_lock",
        "_role": "_state_lock",
        "_storage_degraded_until": "_state_lock",
        "_scratch": "_scratch_lock",
        "counters": "_counters_lock",
    }

    def __init__(self, root: str, *,
                 owner: Optional[str] = None,
                 ttl_s: float = 5.0,
                 host: str = "127.0.0.1",
                 port: int = 0,
                 standby_poll_s: Optional[float] = None,
                 server_kwargs: Optional[dict] = None,
                 retire_on_crash: bool = False,
                 storage_cooldown_s: float = 5.0,
                 server_ready_timeout_s: float = 300.0):
        self.root = os.path.abspath(root)
        self.owner = owner or f"replica-{uuid.uuid4().hex[:8]}"
        self.ttl_s = float(ttl_s)
        self.standby_poll_s = (self.ttl_s / 4.0 if standby_poll_s is None
                               else float(standby_poll_s))
        self.server_kwargs = dict(server_kwargs or {})
        self.retire_on_crash = bool(retire_on_crash)
        self.storage_cooldown_s = float(storage_cooldown_s)
        self.server_ready_timeout_s = float(server_ready_timeout_s)
        self._requests_dir = os.path.join(self.root, "requests")
        self._results_dir = os.path.join(self.root, "results")
        self._transport = TransportServer(self, host=host, port=port)
        self._state_lock = threading.Lock()
        self._server: Optional[FitServer] = None
        self._lease: Optional[journal_mod.Lease] = None
        self._role = "standby"
        self._storage_degraded_until = 0.0
        self._scratch: Optional[FitServer] = None
        self._scratch_lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "elections": 0, "fenced_demotions": 0, "crash_demotions": 0,
            "storage_demotions": 0, "heartbeats": 0, "standby_reads": 0,
            "torn_results": 0,
        }
        self._counters_lock = threading.Lock()
        self._stop = threading.Event()
        self._control: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FleetReplica":
        if self._control is not None:
            raise RuntimeError("FleetReplica.start() called twice")
        self._transport.start()
        host, port = self._transport.address
        advertise_endpoint(self.root, self.owner, host, port)
        self._control = threading.Thread(
            target=self._control_loop, daemon=True,
            name=f"fleet-control-{self.owner}")
        self._control.start()
        return self

    def stop(self, timeout_s: float = 300.0) -> None:
        self._stop.set()
        t = self._control
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._transport.stop()
        with self._scratch_lock:
            scratch, self._scratch = self._scratch, None
        if scratch is not None:
            try:
                scratch.stop(drain=False)
            except Exception:  # noqa: BLE001 - teardown must complete
                pass
        withdraw_endpoint(self.root, self.owner)
        self._publish_state()

    def __enter__(self) -> "FleetReplica":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def address(self) -> Tuple[str, int]:
        return self._transport.address

    def role(self) -> str:
        with self._state_lock:
            return self._role

    def lease_token(self) -> Optional[int]:
        with self._state_lock:
            return None if self._lease is None else self._lease.token

    def wait_role(self, role: str, timeout_s: float = 60.0) -> bool:
        """Poll until this replica reports ``role`` (tests/orchestration)."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            if self.role() == role:
                return True
            time.sleep(0.02)
        return self.role() == role

    # -- the degradation ladder ----------------------------------------------

    def state(self) -> str:
        """Where this replica sits on the degradation ladder:
        ``full`` (primary serving) → ``standby`` (a live leader exists;
        reads served here) → ``read_only`` (leaderless window) →
        ``storage_degraded`` (own disk suspect; sitting out elections)
        → ``retired``/``stopped``.  Distinct from :meth:`role`, which
        stays the raw election role for orchestration."""
        with self._state_lock:
            role = self._role
            degraded_until = self._storage_degraded_until
        if role == "primary":
            return "full"
        if role in ("recovering", "retired", "stopped"):
            return role
        if time.monotonic() < degraded_until:
            return "storage_degraded"
        if not journal_mod.lease_is_live(self.root):
            return "read_only"
        return "standby"

    def _publish_state(self) -> str:
        state = self.state()
        obs.gauge("fleet.state").set(float(STATE_CODES.get(state, -1.0)))
        return state

    def _note_storage_degraded(self, why: str, **fields) -> None:
        """A write on the shared root failed with OSError: mark the disk
        suspect for a cooldown (no elections, reads still served)."""
        until = time.monotonic() + self.storage_cooldown_s
        with self._state_lock:
            self._storage_degraded_until = until
        obs.counter("fleet.storage_degraded").inc()
        obs.event("fleet.step_down", owner=self.owner, reason="storage",
                  why=why, cooldown_s=self.storage_cooldown_s, **fields)
        self._publish_state()

    # -- the control loop (election / heartbeat / demotion) ------------------

    def _control_loop(self) -> None:
        while not self._stop.is_set():
            with self._state_lock:
                degraded_until = self._storage_degraded_until
            if time.monotonic() < degraded_until:
                # suspect disk: a win here would just step down again —
                # sit out elections (reads keep flowing) until cooldown
                self._stop.wait(self.standby_poll_s)
                continue
            try:
                lease = journal_mod.acquire_lease(self.root, self.owner,
                                                  ttl_s=self.ttl_s)
            except OSError as e:
                # could not even WRITE a claim: the root refuses us
                self._note_storage_degraded("acquire_lease",
                                            error=repr(e)[:200])
                continue
            if lease is None:
                self._stop.wait(self.standby_poll_s)
                continue
            srv = _FencedFitServer(self.root, lease, **self.server_kwargs)
            with self._counters_lock:
                self.counters["elections"] += 1
            obs.event("fleet.elected", owner=self.owner, token=lease.token)
            try:
                srv.start(wait_ready=False)
            except RuntimeError:
                pass  # start() raced stop(); the loop below settles it
            with self._state_lock:
                self._lease = lease
                self._server = srv
                self._role = "recovering"
            self._publish_state()
            outcome = self._serve_as_primary(srv, lease)
            # demotion: tear the server down first, then settle the lease
            try:
                srv.stop(drain=(outcome == "stopping"))
            except Exception:  # noqa: BLE001 - demotion must complete
                pass
            try:
                lease.release()
            except (FencedError, OSError):
                # the successor already owns the root, or the disk that
                # just demoted us refuses the release too — either way
                # the lease record expires by TTL
                pass
            with self._state_lock:
                self._lease = None
                self._server = None
                self._role = "standby"
            if outcome == "fenced":
                with self._counters_lock:
                    self.counters["fenced_demotions"] += 1
                obs.event("fleet.fenced", owner=self.owner,
                          token=lease.token)
            elif outcome == "storage":
                with self._counters_lock:
                    self.counters["storage_demotions"] += 1
                self._note_storage_degraded("step_down", token=lease.token)
            elif outcome == "crashed":
                with self._counters_lock:
                    self.counters["crash_demotions"] += 1
                if self.retire_on_crash:
                    with self._state_lock:
                        self._role = "retired"
                    self._publish_state()
                    return
            self._publish_state()
        with self._state_lock:
            if self._role != "retired":
                self._role = "stopped"

    def _serve_as_primary(self, srv: FitServer,
                          lease: journal_mod.Lease) -> str:
        """Heartbeat until stop/crash/fence; returns the demotion cause.
        The heartbeat runs DURING recovery too — a takeover whose replay
        outlives the ttl must not lose the lease it is replaying under."""
        beat = max(0.01, self.ttl_s / 3.0)
        last = 0.0
        ready_at: Optional[float] = None
        while not self._stop.is_set():
            now = time.monotonic()
            if now - last >= beat:
                try:
                    lease.heartbeat()
                except FencedError:
                    return "fenced"
                except OSError:
                    # a heartbeat that cannot LAND is a storage fault,
                    # not a lost election: step down before the stale
                    # record fences us mid-write
                    return "storage"
                last = now
                with self._counters_lock:
                    self.counters["heartbeats"] += 1
            state = srv.state()
            if state == "crashed":
                err = getattr(srv, "_crash_error", None)
                if isinstance(err, FencedError):
                    return "fenced"  # a commit or store found a higher claim
                if isinstance(err, OSError):
                    return "storage"  # serve loop died on a disk write
                return "crashed"
            if state in ("ready", "degraded"):
                with self._state_lock:
                    if self._role == "recovering":
                        self._role = "primary"
                ready_at = ready_at or now
            elif ready_at is None and srv._ready.is_set():
                # recovery finished but crashed/stopped settles next tick
                ready_at = now
            self._stop.wait(min(beat / 2.0, 0.05))
        return "stopping"

    # -- serving backend facade (what TransportServer dispatches into) -------

    def _primary(self) -> FitServer:
        with self._state_lock:
            srv, role = self._server, self._role
        if srv is None or role not in ("primary", "recovering"):
            holder = journal_mod.read_lease(self.root) or {}
            if not journal_mod.lease_is_live(self.root):
                # leaderless window: there is no "elsewhere" to redirect
                # to — typed read_only tells the client to retry LATER
                # (an election is in flight) while reads keep flowing
                raise transport_mod.ReadOnlyError(
                    f"replica {self.owner!r} is {role} and the fleet is "
                    "leaderless (election in flight); reads are served, "
                    "writes must wait",
                    retry_after_s=max(0.1, self.ttl_s / 2.0))
            raise NotLeaderError(
                f"replica {self.owner!r} is {role}; current lease holder "
                f"is {holder.get('owner')!r} (token {holder.get('token')})")
        return srv

    def _scratch_server(self) -> FitServer:
        """The standby's private compute root for READ-class requests
        (``<root>/standby_scratch/<owner>``): per-owner, never under the
        single-writer namespaces, so a scratch walk cannot collide with
        the primary's fenced writes.  Lazy — a standby that never serves
        a read never pays for it — and kept across promotions (a primary
        still answers polls for reads it computed as a standby)."""
        with self._scratch_lock:
            if self._scratch is None:
                kwargs = dict(self.server_kwargs)
                kwargs.pop("_commit_hook", None)  # fault hooks fence the
                # PRIMARY root; scratch walks are nobody's fencing domain
                srv = FitServer(
                    os.path.join(self.root, SCRATCH_DIR, self.owner),
                    **kwargs)
                srv.start(wait_ready=False)
                self._scratch = srv
            return self._scratch

    def submit(self, tenant, values, model="arima", **kwargs):
        return self._primary().submit(tenant, values, model, **kwargs)

    def submit_forecast(self, tenant, values, fitted, **kwargs):
        with self._state_lock:
            srv, role = self._server, self._role
        if srv is not None and role in ("primary", "recovering"):
            return srv.submit_forecast(tenant, values, fitted, **kwargs)
        if role in ("retired", "stopped"):
            # retired/stopped replicas serve nothing; the transport is
            # usually down too, but a racing in-flight call gets truth
            raise NotLeaderError(
                f"replica {self.owner!r} is {role}")
        # STANDBY READ: a forecast derives from the request's own params
        # with a content-derived interval seed, so any replica computes
        # it bitwise-identically — answer from the shared durable result
        # when one exists, else compute on the private scratch root
        req_id = kwargs.get("request_id")
        if req_id:
            path = os.path.join(self._results_dir, f"{req_id}.npz")
            if os.path.exists(path):
                try:
                    res = _load_result_file(path)
                except Exception as e:  # noqa: BLE001 - torn: downgrade
                    self._discard_torn(path, e)
                else:
                    with self._counters_lock:
                        self.counters["standby_reads"] += 1
                    obs.counter("fleet.standby_reads").inc()
                    ticket = FitTicket(req_id)
                    ticket._resolve(res)
                    return ticket
        with self._counters_lock:
            self.counters["standby_reads"] += 1
        obs.counter("fleet.standby_reads").inc()
        obs.event("fleet.standby_read", owner=self.owner,
                  req_id=req_id or "")
        return self._scratch_server().submit_forecast(tenant, values,
                                                      fitted, **kwargs)

    def request_pending(self, req_id: str) -> bool:
        with self._state_lock:
            srv = self._server
        if srv is not None and srv.request_pending(req_id):
            return True
        with self._scratch_lock:
            scratch = self._scratch
        if scratch is not None and scratch.request_pending(req_id):
            return True
        return os.path.exists(os.path.join(self._requests_dir,
                                           f"{req_id}.npz"))

    def _discard_torn(self, path: str, err: BaseException) -> None:
        """A stored result that fails to decode is TORN (a crashed or
        faulted writer): discard it so the id downgrades to
        recompute-or-redirect — a torn answer is never served."""
        with self._counters_lock:
            self.counters["torn_results"] += 1
        obs.counter("fleet.torn_results").inc()
        obs.event("fleet.torn_result", owner=self.owner,
                  file=os.path.basename(path), error=repr(err)[:200])
        try:
            os.remove(path)
        except OSError:
            pass

    def result_for(self, req_id: str) -> TenantFitResult:
        """Results are durable files: ANY replica answers a completed
        request's poll, so clients never wait out a lease TTL just to
        read an answer that already exists.  A torn file is discarded
        (the client's idempotent resubmit recomputes it); a scratch-
        computed standby read answers from the scratch server."""
        path = os.path.join(self._results_dir, f"{req_id}.npz")
        if os.path.exists(path):
            try:
                res = _load_result_file(path)
            except Exception as e:  # noqa: BLE001 - torn: downgrade
                self._discard_torn(path, e)
                raise KeyError(
                    f"stored result for {req_id!r} was torn and has been "
                    "discarded — resubmit (idempotent by id)") from e
            if self.role() != "primary":
                with self._counters_lock:
                    self.counters["standby_reads"] += 1
                obs.counter("fleet.standby_reads").inc()
                obs.event("fleet.standby_read", owner=self.owner,
                          req_id=req_id)
            return res
        with self._scratch_lock:
            scratch = self._scratch
        if scratch is not None:
            return scratch.result_for(req_id)
        raise KeyError(f"no stored result for request {req_id!r}")

    def health(self) -> dict:
        with self._state_lock:
            srv, role = self._server, self._role
            token = None if self._lease is None else self._lease.token
        with self._counters_lock:
            counters = dict(self.counters)
        state = self._publish_state()
        out = {
            "role": role,
            "state": state,
            "storage_degraded": state == "storage_degraded",
            "owner": self.owner,
            "lease_token": token,
            "fleet": counters,
            "lease": journal_mod.read_lease(self.root),
            "root": self.root,
        }
        if srv is not None and role in ("primary", "recovering"):
            out["server"] = srv.health()
        return out

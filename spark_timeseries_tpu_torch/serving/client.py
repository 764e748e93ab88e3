"""FitClient: the kill-tolerant caller side of the fleet wire protocol
(port of ``serving/client.py``).

The serving contract callers rely on is *at-least-once delivery,
exactly-once answering*: a request id is idempotent end to end
(the durable record, the batch digest, the stored result), so the client
is free to retry aggressively — a resubmit of an admitted id is acked,
a resubmit of a completed id returns the stored bytes, and a resubmit
after the admitting replica was SIGKILLed lands on the surviving peer.
:class:`FitClient` packages that into a synchronous facade shaped like
:class:`~.server.FitServer` itself (``submit`` / ``submit_forecast``
returning tickets), so ``run_backtest(server=client)`` storms a fleet
exactly the way it storms an in-process server.  The client is host
code: a tensor argument (values, a fit result's parameters or status, on
any device) is read to the host once, and only host bytes go on the
wire; results come back as host arrays.

- **idempotent resubmit**: the client names every request
  (``request_id`` or a generated ``c-<hex>`` id) and keeps the encoded
  submit bytes; any ambiguity (reset mid-ack, ``unknown_request`` from a
  peer that never saw the dead replica's un-journaled admission) is
  resolved by resubmitting the same id.
- **bounded retries, deterministic backoff**: transport faults and
  ``rejected``/``not_leader`` replies retry up to ``retries`` times with
  exponential backoff whose jitter derives from ``sha256(seed, attempt)``
  — the same seed replays the same schedule (:func:`backoff_schedule`),
  so backpressure behavior is testable byte-for-byte.
- **per-call deadlines**: every blocking call (submit, poll, result)
  runs under a wall-clock budget and raises the *typed*
  :class:`ClientDeadlineError` when it expires — a dead fleet can cost a
  caller its deadline, never a hang.
- **reconnect-safe polling**: results are polled by id over whatever
  connection currently works; a ticket survives any number of
  connection resets and replica failovers because the id, not the
  socket, is the request's identity.
- **health-aware routing**: endpoint choice goes through an
  :class:`~.health.EndpointHealthCache` — writes prefer the believed
  primary, reads fan out to whatever is healthy (standbys serve reads),
  a repeatedly-failing endpoint's circuit opens for a seeded
  deterministic cooldown, and a ``not_leader`` redirect steers writes
  away for a lease-TTL-ish memo window.  Slow result polls optionally
  HEDGE to a second healthy endpoint (``hedge_after_s``): results are
  durable bytes, identical from every replica, so hedging is
  bitwise-neutral — first answer wins.
- **typed degradation**: ``read_only`` (leaderless window — retry
  later) and ``storage_degraded`` (this replica's disk refuses writes —
  retry ELSEWHERE) replies are retried with their own policies;
  ``auth_failed`` (shared-secret mismatch) is terminal
  :class:`~.transport.WireAuthError` — retrying cannot help.
"""

from __future__ import annotations

import hashlib
import io
import json
import socket
import threading
import time
import uuid
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import obs
from ..reliability.runner import _host
from . import transport
from .health import EndpointHealthCache
from .session import (RejectedError, ServerClosedError, StorageError,
                      TenantFitResult)

__all__ = [
    "ClientDeadlineError",
    "FitClient",
    "RemoteTicket",
    "backoff_schedule",
]


class ClientDeadlineError(RuntimeError):
    """A client call's wall-clock budget expired before the fleet
    answered.  The request itself may still be in flight server-side
    (durable by id); re-poll or resubmit with the same ``request_id``."""

    def __init__(self, what: str, deadline_s: float):
        super().__init__(
            f"{what} exceeded its {deadline_s:.2f}s deadline; the request "
            "id stays idempotent — poll or resubmit it")
        self.deadline_s = float(deadline_s)


def backoff_schedule(seed: int, attempts: int, *,
                     base_s: float = 0.05,
                     max_s: float = 2.0) -> List[float]:
    """The client's deterministic backoff schedule: exponential growth
    with multiplicative jitter in ``[0.5, 1.0)`` derived from
    ``sha256(seed, attempt)`` — same seed, same schedule, every process,
    every run (the property the retry tests assert)."""
    out = []
    for attempt in range(int(attempts)):
        cap = min(float(max_s), float(base_s) * (2.0 ** attempt))
        digest = hashlib.sha256(
            f"backoff:{int(seed)}:{attempt}".encode()).digest()
        frac = 0.5 + (int.from_bytes(digest[:8], "big") / 2.0 ** 64) * 0.5
        out.append(cap * frac)
    return out


class _ConnDropped(transport.TransportError):
    """Internal: the current connection died mid-call; rotate + retry."""


class RemoteTicket:
    """The caller's handle for one fleet request: resolves by POLLING
    the durable result by id, so it survives connection resets, replica
    SIGKILLs, and failovers (``FitTicket`` semantics, minus the process
    locality)."""

    def __init__(self, client: "FitClient", req_id: str,
                 resubmit: Tuple[dict, bytes]):
        self.req_id = req_id
        self._client = client
        self._resubmit = resubmit  # (header, blob): idempotent re-offer
        self._result: Optional[TenantFitResult] = None

    def done(self) -> bool:
        if self._result is not None:
            return True
        try:
            self._result = self._client._poll_once(self.req_id,
                                                   self._resubmit)
        except transport.TransportError:
            return False
        return self._result is not None

    def result(self, timeout: Optional[float] = None) -> TenantFitResult:
        """Block for the result (``ClientDeadlineError`` on expiry).
        ``timeout=None`` uses the client's default call deadline."""
        if self._result is not None:
            return self._result
        self._result = self._client._poll_result(self.req_id,
                                                 self._resubmit, timeout)
        return self._result


class FitClient:
    """Socket client over one or more fleet endpoints (see module doc).

    .. attribute:: _protected_by_

        Lock-discipline contract (the lint lock map): tickets may be
        polled from many caller threads (``run_backtest`` worker pools);
        the connection, endpoint cursor, and message sequence mutate
        only under the I/O lock — one request/reply round trip at a
        time per client.

    ``endpoints`` is a list of ``(host, port)`` tuples or
    ``"host:port"`` strings; the client rotates through them on
    connection failure and ``not_leader`` replies, which is the whole
    failover story — the lease decides who answers, the client just
    keeps knocking.
    """

    _protected_by_ = {
        "_sock": "_io_lock",
        "_decoder": "_io_lock",
        "_cur_ep": "_io_lock",
        "_msg_seq": "_io_lock",
        "_clock": "_io_lock",
    }

    def __init__(self, endpoints: Sequence[Union[str, Tuple[str, int]]], *,
                 retries: int = 16,
                 backoff_base_s: float = 0.05,
                 backoff_max_s: float = 2.0,
                 seed: int = 0,
                 deadline_s: Optional[float] = 300.0,
                 poll_interval_s: float = 0.05,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 60.0,
                 failure_threshold: int = 3,
                 hedge_after_s: Optional[float] = None,
                 secret=None,
                 _wire_wrap: Optional[Callable] = None):
        eps = []
        for ep in endpoints:
            if isinstance(ep, str):
                host, _, port = ep.rpartition(":")
                eps.append((host or "127.0.0.1", int(port)))
            else:
                eps.append((str(ep[0]), int(ep[1])))
        if not eps:
            raise ValueError("FitClient needs at least one endpoint")
        self.endpoints = eps
        self.retries = int(retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.seed = int(seed)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.poll_interval_s = float(poll_interval_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        # hedged result polls: after this many seconds of pending, every
        # poll ALSO asks the next-best healthy endpoint (None = off)
        self.hedge_after_s = (None if hedge_after_s is None
                              else float(hedge_after_s))
        self._secret = transport.resolve_wire_secret(secret)
        self.endpoint_health = EndpointHealthCache(
            eps, seed=seed, failure_threshold=failure_threshold)
        # fault-injection seam: wraps each fresh connection in a lossy
        # wire (reliability.faultinject.FaultyWire) — tests only
        self._wire_wrap = _wire_wrap
        self._io_lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._decoder = transport.FrameDecoder()
        self._cur_ep: Optional[Tuple[str, int]] = None
        self._msg_seq = 0
        # per-endpoint monotonic-clock offset estimates: when
        # tracing is on, each reply carries the replica's time.monotonic
        # and the midpoint estimate with the SMALLEST observed rtt wins —
        # journaled next to the obs stream at close() so merged fleet
        # timelines are orderable without trusting wall clocks
        self._clock: dict = {}

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self._write_clock_journal()
        with self._io_lock:
            self._close_locked()

    def _write_clock_journal(self) -> None:
        """Journal the per-endpoint clock-offset estimates as a sidecar
        JSON next to the obs JSONL stream (``<stream>.clock.json``) —
        the artifact ``obs_report --fleet`` reads to order cross-process
        timelines.  Structurally a no-op unless the obs plane is on
        with a stream AND at least one estimate exists, so a disabled
        run writes nothing (bitwise-inert contract)."""
        path = obs.stream_path()
        with self._io_lock:
            clock = dict(self._clock)
        if path is None or not clock:
            return
        record = {
            "kind": "clock_offsets",
            "endpoints": {f"{h}:{p}": est for (h, p), est in
                          sorted(clock.items())},
        }
        try:
            with open(path + ".clock.json", "w", encoding="utf-8") as f:
                f.write(json.dumps(record, indent=1, sort_keys=True))
        except OSError:
            pass  # telemetry sidecar: never let it break close()

    def __enter__(self) -> "FitClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._cur_ep = None
        self._decoder = transport.FrameDecoder()

    def _connect_locked(self, write: bool = False) -> None:
        if write and self._sock is not None:
            # a write on a read connection: if the cache believes the
            # primary is elsewhere, move there instead of bouncing off
            # a standby's not_leader
            want = self.endpoint_health.believed_primary()
            if want is not None and self._cur_ep != want:
                self._close_locked()
        if self._sock is not None:
            return
        host, port = self.endpoint_health.order(write=write)[0]
        try:
            s = socket.create_connection((host, port),
                                         timeout=self.connect_timeout_s)
        except OSError as e:
            self.endpoint_health.record_failure((host, port))
            raise _ConnDropped(
                f"connect to {host}:{port} failed: {e}") from None
        s.settimeout(self.io_timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        if self._wire_wrap is not None:
            s = self._wire_wrap(s)
        self._sock = s
        self._cur_ep = (host, port)
        self._decoder = transport.FrameDecoder()

    def _rotate_locked(self) -> None:
        # the health cache decides where the NEXT connect lands; the
        # failure/redirect records made this endpoint sort later
        if self._cur_ep is not None:
            obs.event("client.rotate", endpoint=list(self._cur_ep))
        self._close_locked()

    # -- one round trip ------------------------------------------------------

    def _call_once(self, header: dict, blob: bytes = b"",
                   write: bool = False) -> Tuple[dict, bytes]:
        """One request/reply round trip on the current connection
        (raises :class:`_ConnDropped` on any transport-level failure,
        leaving the connection closed).  Health recording happens here,
        where the endpoint is known: any reply is a liveness success,
        ``not_leader`` memos the redirect, ``storage_degraded`` counts
        as a failure (prefer other replicas), a clean write ack marks
        the believed primary."""
        with self._io_lock:
            self._connect_locked(write=write)
            ep = self._cur_ep
            self._msg_seq += 1
            msg_id = f"m{self._msg_seq}"
            hdr = {**header, "msg_id": msg_id}
            tctx = obs.current_trace()
            if tctx is not None:  # trace rides the wire
                hdr["trace"] = obs.trace_to_wire(tctx)
            t0 = time.monotonic()
            try:
                transport.send_msg(self._sock, hdr, blob, self._secret)
                while True:
                    msg = transport.recv_msg(self._sock, self._decoder,
                                             secret=self._secret)
                    if msg is None:
                        raise transport.FrameError(
                            "connection closed before the reply")
                    reply, rblob = msg
                    # duplicated-frame faults can surface stale replies;
                    # the msg_id echo pairs replies with calls exactly
                    if reply.get("error") == "auth_failed":
                        # terminal: the server refused OUR bytes — a
                        # shared-secret mismatch no retry can fix
                        raise transport.WireAuthError(
                            reply.get("message", "auth_failed"))
                    if reply.get("msg_id") in (None, msg_id):
                        err = reply.get("error")
                        if err == "storage_degraded":
                            self.endpoint_health.record_failure(ep)
                        elif err == "not_leader":
                            self.endpoint_health.record_redirect(ep)
                        else:
                            t1 = time.monotonic()
                            self.endpoint_health.record_success(ep, t1 - t0)
                            if write and err is None:
                                self.endpoint_health.set_primary(ep)
                            self._update_clock_locked(ep, reply, t0, t1)
                        return reply, rblob
            except transport.WireAuthError:
                self._close_locked()
                raise
            except (transport.TransportError, OSError) as e:
                self.endpoint_health.record_failure(ep)
                self._rotate_locked()
                raise _ConnDropped(f"call failed mid-flight: {e}") from None

    def _update_clock_locked(self, ep, reply: dict, t0: float,
                             t1: float) -> None:
        """Fold a reply's replica-monotonic timestamp into this
        endpoint's clock-offset estimate (caller holds ``_io_lock``).
        NTP-style midpoint: ``offset = ts_mono - (t0 + t1) / 2``; the
        estimate with the smallest round trip wins (least midpoint
        slack).  Replies without ``ts_mono`` — tracing off, old servers
        — leave the table untouched."""
        ts_mono = reply.get("ts_mono")
        if not isinstance(ts_mono, (int, float)) or ep is None:
            return
        rtt = t1 - t0
        offset = float(ts_mono) - (t0 + t1) / 2.0
        prev = self._clock.get(ep)
        if prev is None or rtt < prev["rtt_s"]:
            self._clock[ep] = {"offset_s": round(offset, 6),
                               "rtt_s": round(rtt, 6)}
            obs.event("client.clock_offset", endpoint=list(ep),
                      offset_s=round(offset, 6), rtt_s=round(rtt, 6))

    def _call(self, header: dict, blob: bytes = b"", *,
              what: str, deadline_s: Optional[float] = None,
              resubmit_ok: bool = True,
              write: bool = False) -> Tuple[dict, bytes]:
        """A round trip under the retry/backoff/deadline policy.

        Retryable outcomes — dropped connections, ``not_leader`` (a
        standby answered; the new primary needs a lease TTL to take
        over), ``read_only`` (leaderless window: retry LATER),
        ``storage_degraded`` (this replica's disk refuses writes: retry
        ELSEWHERE), ``closed`` (a draining replica), ``rejected``
        (backpressure: honors ``retry_after_s``) — burn one bounded
        retry each, sleeping the deterministic backoff schedule between
        attempts.  Typed terminal outcomes raise: bad requests
        (``ValueError``), auth failures
        (:class:`~.transport.WireAuthError` from the round trip),
        deadline expiry (:class:`ClientDeadlineError`), retries
        exhausted (the last error)."""
        budget = self.deadline_s if deadline_s is None else float(deadline_s)
        t0 = time.monotonic()
        schedule = backoff_schedule(self.seed, self.retries + 1,
                                    base_s=self.backoff_base_s,
                                    max_s=self.backoff_max_s)
        last: Optional[BaseException] = None
        for attempt in range(self.retries + 1):
            if budget is not None and time.monotonic() - t0 >= budget:
                raise ClientDeadlineError(what, budget)
            try:
                reply, rblob = self._call_once(header, blob, write=write)
            except _ConnDropped as e:
                last = e
                self._sleep_backoff(schedule[attempt], t0, budget, what)
                continue
            err = reply.get("error")
            if err is None:
                return reply, rblob
            if err == "rejected":
                last = RejectedError(
                    reply.get("message", "rejected"),
                    retry_after_s=float(reply.get("retry_after_s") or 1.0),
                    shed=bool(reply.get("shed")))
                if not resubmit_ok:
                    raise last
                self._sleep_backoff(
                    max(schedule[attempt], last.retry_after_s),
                    t0, budget, what)
                continue
            if err == "storage_degraded":
                # _call_once already dinged the endpoint's health; the
                # next connect prefers a replica whose disk works
                last = StorageError(
                    reply.get("message", "storage degraded"),
                    retry_after_s=float(reply.get("retry_after_s") or 5.0))
                if not resubmit_ok:
                    raise last
                with self._io_lock:
                    self._rotate_locked()
                self._sleep_backoff(schedule[attempt], t0, budget, what)
                continue
            if err == "read_only":
                # leaderless window: nobody can admit writes anywhere —
                # wait out the election rather than hammering peers
                last = ServerClosedError(reply.get("message", err))
                with self._io_lock:
                    self._rotate_locked()
                self._sleep_backoff(
                    max(schedule[attempt],
                        float(reply.get("retry_after_s") or 0.5)),
                    t0, budget, what)
                continue
            if err in ("not_leader", "closed", "fenced"):
                # the lease is (re)electing; knock on the next replica
                last = ServerClosedError(reply.get("message", err))
                with self._io_lock:
                    self._rotate_locked()
                self._sleep_backoff(schedule[attempt], t0, budget, what)
                continue
            if err == "unknown_request":
                raise KeyError(reply.get("message", "unknown request"))
            if err == "bad_request":
                raise ValueError(reply.get("message", "bad request"))
            raise RuntimeError(
                f"fleet internal error: {reply.get('message')}")
        raise (last if last is not None else
               transport.TransportError(f"{what}: retries exhausted"))

    def _sleep_backoff(self, delay: float, t0: float,
                       budget: Optional[float], what: str) -> None:
        if budget is not None:
            remaining = budget - (time.monotonic() - t0)
            if remaining <= 0:
                raise ClientDeadlineError(what, budget)
            delay = min(delay, remaining)
        if delay > 0:
            obs.event("client.backoff", what=what, delay_s=round(delay, 6))
            time.sleep(delay)

    # -- public API ----------------------------------------------------------

    def ping(self) -> bool:
        reply, _ = self._call({"op": "ping"}, what="ping")
        return bool(reply.get("ok"))

    def health(self) -> dict:
        reply, _ = self._call({"op": "health"}, what="health")
        return reply.get("health") or {}

    def submit(self, tenant: str, values, model: str = "arima", *,
               priority: int = 0, deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               call_deadline_s: Optional[float] = None,
               **fit_kwargs) -> RemoteTicket:
        """Admit one panel fit over the wire; returns a
        :class:`RemoteTicket`.  ``deadline_s`` is the SERVER-side request
        deadline (watchdog contract); ``call_deadline_s`` bounds this
        client call's wall clock (default: the client's ``deadline_s``).
        ``request_id`` makes the submit idempotent across any number of
        retries, resets, and replica deaths — omitted, the client
        generates one."""
        req_id = request_id or f"c-{uuid.uuid4().hex[:16]}"
        meta = {
            "req_id": req_id, "tenant": str(tenant), "model": str(model),
            "fit_kwargs": json.loads(json.dumps(dict(fit_kwargs))),
            "priority": int(priority),
            "deadline_s": None if deadline_s is None else float(deadline_s),
        }
        blob = transport.encode_request_blob(values, meta)
        header = {"op": "submit"}
        with obs.trace_scope(obs.trace_for_request(req_id, "client")):
            obs.event("client.submit", req_id=req_id, tenant=str(tenant),
                      op="submit")
            reply, _ = self._call(header, blob, what=f"submit({req_id})",
                                  deadline_s=call_deadline_s, write=True)
        got = reply.get("req_id")
        if got != req_id:
            raise transport.TransportError(
                f"submit ack names {got!r}, expected {req_id!r}")
        obs.counter("client.submitted").inc()
        return RemoteTicket(self, req_id, (header, blob))

    def submit_forecast(self, tenant: str, values, fitted, *,
                        model: str = "arima", horizon: int = 1,
                        model_kwargs: Optional[dict] = None,
                        status=None, intervals: bool = False,
                        level: float = 0.9, n_samples: int = 256,
                        seed: Optional[int] = None, priority: int = 0,
                        deadline_s: Optional[float] = None,
                        request_id: Optional[str] = None,
                        call_deadline_s: Optional[float] = None
                        ) -> RemoteTicket:
        """Admit one panel forecast over the wire — the
        ``run_backtest(server=client)`` surface.  ``fitted`` follows
        :meth:`~.server.FitServer.submit_forecast` semantics (a fit
        result or a raw ``[rows, k]`` array); augmentation happens
        server-side so the durable record matches an in-process
        submit's byte for byte."""
        req_id = request_id or f"c-{uuid.uuid4().hex[:16]}"
        if hasattr(fitted, "params"):
            params = _host(fitted.params)
            if status is None:
                status = getattr(fitted, "status", None)
        else:
            params = _host(fitted)
        meta = {
            "req_id": req_id, "tenant": str(tenant),
            "priority": int(priority),
            "deadline_s": None if deadline_s is None else float(deadline_s),
            "forecast": {
                "model": str(model), "horizon": int(horizon),
                "model_kwargs": {
                    k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in (model_kwargs or {}).items()},
                "intervals": bool(intervals), "level": float(level),
                "n_samples": int(n_samples),
                "seed": None if seed is None else int(seed),
            },
        }
        buf = io.BytesIO()
        arrays = {"values": np.ascontiguousarray(_host(values)),
                  "fitted": np.ascontiguousarray(params),
                  "meta": np.frombuffer(
                      json.dumps(meta, sort_keys=True).encode(),
                      dtype=np.uint8)}
        if status is not None:
            arrays["status"] = np.ascontiguousarray(_host(status))
        np.savez(buf, **arrays)
        blob = buf.getvalue()
        # deliberately a READ-class call: forecasts derive from journaled
        # params with a content-derived base seed, so ANY replica (a
        # standby included) answers them bitwise-identically — this is
        # the read load the standbys exist to carry
        header = {"op": "submit_forecast"}
        with obs.trace_scope(obs.trace_for_request(req_id, "client")):
            obs.event("client.submit", req_id=req_id, tenant=str(tenant),
                      op="submit_forecast")
            reply, _ = self._call(header, blob,
                                  what=f"submit_forecast({req_id})",
                                  deadline_s=call_deadline_s)
        got = reply.get("req_id")
        if got != req_id:
            raise transport.TransportError(
                f"submit ack names {got!r}, expected {req_id!r}")
        obs.counter("client.submitted").inc()
        return RemoteTicket(self, req_id, (header, blob))

    def result_for(self, req_id: str,
                   timeout: Optional[float] = None) -> TenantFitResult:
        """Poll a request's stored result by id (how a restarted CLIENT
        re-attaches: the id is the identity, not the ticket object).
        Raises ``KeyError`` for an id the fleet has never admitted."""
        return self._poll_result(req_id, None, timeout)

    # -- polling internals ---------------------------------------------------

    def _poll_once(self, req_id: str,
                   resubmit: Optional[Tuple[dict, bytes]]
                   ) -> Optional[TenantFitResult]:
        """One poll: the result, None while pending.  An
        ``unknown_request`` reply means the admitting replica died
        before its write-ahead record landed — resubmit the identical
        bytes (idempotent) and report pending."""
        with obs.trace_scope(obs.trace_for_request(req_id, "client")):
            try:
                reply, rblob = self._call({"op": "result", "req_id": req_id},
                                          what=f"result({req_id})")
            except KeyError:
                if resubmit is None:
                    raise
                header, blob = resubmit
                obs.event("client.resubmit", req_id=req_id)
                self._call(header, blob, what=f"resubmit({req_id})")
                obs.counter("client.resubmitted").inc()
                return None
            if reply.get("done"):
                res = transport.decode_result_blob(rblob)
                if resubmit is not None:
                    # THE terminal of the request's causal timeline: a
                    # submitted ticket observed the durable answer
                    # (obs_report --trace gates on exactly one of these
                    # per stormed request).  result_for() re-reads pass
                    # resubmit=None and stay terminal-silent — a probe
                    # loop re-polling a done id is a READ, not the
                    # request completing again.
                    obs.event("client.result", req_id=req_id)
                return res
            return None

    def _poll_result(self, req_id: str,
                     resubmit: Optional[Tuple[dict, bytes]],
                     timeout: Optional[float]) -> TenantFitResult:
        budget = self.deadline_s if timeout is None else float(timeout)
        t0 = time.monotonic()
        hedging = False
        with obs.trace_scope(obs.trace_for_request(req_id, "client")):
            while True:
                res = self._poll_once(req_id, resubmit)
                if res is not None:
                    return res
                if (self.hedge_after_s is not None
                        and len(self.endpoints) > 1
                        and time.monotonic() - t0 >= self.hedge_after_s):
                    if not hedging:
                        hedging = True
                        obs.counter("client.hedge_launched").inc()
                        obs.event("client.hedge", req_id=req_id)
                    res = self._hedge_poll_once(req_id)
                    if res is not None:
                        obs.counter("client.hedge_won").inc()
                        if resubmit is not None:  # same terminal contract
                            obs.event("client.result", req_id=req_id,
                                      hedged=True)
                        return res
                if budget is not None and \
                        time.monotonic() - t0 + self.poll_interval_s > budget:
                    raise ClientDeadlineError(f"result({req_id})", budget)
                time.sleep(self.poll_interval_s)

    def _hedge_poll_once(self, req_id: str) -> Optional[TenantFitResult]:
        """One hedged result poll against the best endpoint OTHER than
        the current connection's, over a throwaway connection.  Results
        are durable bytes — identical from every replica — so whichever
        side answers first is the answer.  Any failure just records
        endpoint health and returns None; the main poll loop is the
        arbiter of deadlines."""
        with self._io_lock:
            cur = self._cur_ep
        alt = next((ep for ep in self.endpoint_health.order()
                    if ep != cur), None)
        if alt is None:
            return None
        try:
            s = socket.create_connection(alt,
                                         timeout=self.connect_timeout_s)
        except OSError:
            self.endpoint_health.record_failure(alt)
            return None
        try:
            s.settimeout(self.io_timeout_s)
            if self._wire_wrap is not None:
                s = self._wire_wrap(s)
            decoder = transport.FrameDecoder()
            transport.send_msg(
                s, {"op": "result", "req_id": req_id, "msg_id": "hedge"},
                secret=self._secret)
            while True:
                msg = transport.recv_msg(s, decoder, secret=self._secret)
                if msg is None:
                    return None
                reply, rblob = msg
                if reply.get("msg_id") in (None, "hedge"):
                    break
            self.endpoint_health.record_success(alt)
            if reply.get("done"):
                return transport.decode_result_blob(rblob)
            return None
        except (transport.TransportError, transport.WireAuthError,
                OSError):
            self.endpoint_health.record_failure(alt)
            return None
        finally:
            try:
                s.close()
            except OSError:
                pass

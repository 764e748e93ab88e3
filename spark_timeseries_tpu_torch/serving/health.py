"""Client-side endpoint health: the cache that turns a dumb endpoint
list into informed routing (port of ``serving/health.py``).

A client that treats its endpoints as a blind rotation advances a cursor
on every failure, and every caller re-discovers the same dead replica by
timing out on it.  This cache remembers:

- **consecutive-failure circuit breaker**: an endpoint that fails
  ``failure_threshold`` calls in a row has its circuit opened for a
  cooldown; while open it sorts LAST (tried only when everything else
  is worse), and when the cooldown elapses exactly one call probes it
  (half-open) before the circuit fully closes again.
- **seeded deterministic cooldowns**: the cooldown for the N-th
  consecutive opening is exponential with multiplicative jitter derived
  from ``sha256(seed, endpoint, opening)`` — the same seed replays the
  same schedule in every process, so failover timing is testable
  byte-for-byte (the same construction as
  :func:`~.client.backoff_schedule`).
- **EWMA latency**: successful calls fold their wall clock into an
  exponentially-weighted moving average per endpoint, the tiebreak
  among equally-healthy endpoints (rounded to 10 ms so measurement
  noise cannot flap the order).
- **primary belief**: a successful WRITE marks its endpoint as the
  believed primary; a ``not_leader`` redirect clears the belief.
  :meth:`order` puts the believed primary first for writes and is
  indifferent for reads — reads fan out to whatever is healthy,
  which is what lets standbys carry read load.

Everything here is bitwise-neutral: the cache only changes WHERE a
request lands, never what bytes answer it (results are durable npz
records, identical from every replica).  ``now`` is injectable on every
mutating call so tests drive the clock explicitly.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, List, Optional, Tuple

from .. import obs

__all__ = ["EndpointHealthCache", "cooldown_schedule"]

Endpoint = Tuple[str, int]


def cooldown_schedule(seed: int, endpoint: Endpoint, openings: int, *,
                      base_s: float = 0.25,
                      max_s: float = 8.0) -> List[float]:
    """The deterministic circuit-open cooldowns for one endpoint: the
    N-th consecutive opening waits ``min(max_s, base_s * 2**N)`` scaled
    by jitter in ``[0.5, 1.0)`` from ``sha256(seed, endpoint, N)`` —
    same seed, same schedule, every process (mirrors
    :func:`~.client.backoff_schedule`)."""
    out = []
    for n in range(int(openings)):
        cap = min(float(max_s), float(base_s) * (2.0 ** n))
        digest = hashlib.sha256(
            f"cooldown:{int(seed)}:{endpoint[0]}:{endpoint[1]}:{n}"
            .encode()).digest()
        frac = 0.5 + (int.from_bytes(digest[:8], "big") / 2.0 ** 64) * 0.5
        out.append(cap * frac)
    return out


class _EndpointRecord:
    __slots__ = ("consec_failures", "open_until", "openings", "ewma_s",
                 "successes", "failures", "probing", "redirected_until")

    def __init__(self):
        self.consec_failures = 0
        self.open_until: Optional[float] = None  # monotonic; None=closed
        self.openings = 0  # consecutive circuit openings (cooldown index)
        self.ewma_s: Optional[float] = None
        self.successes = 0
        self.failures = 0
        self.probing = False  # half-open: one in-flight probe
        self.redirected_until: Optional[float] = None  # "not primary" memo


class EndpointHealthCache:
    """Per-endpoint health state shared by one client (see module doc).

    .. attribute:: _protected_by_

        Lock-discipline contract (the lint lock map): many caller
        threads poll tickets concurrently and every one of them reads
        and mutates the shared records — all record and primary-belief
        mutation happens under the cache lock.
    """

    _protected_by_ = {
        "_records": "_lock",
        "_primary": "_lock",
    }

    def __init__(self, endpoints, *, seed: int = 0,
                 failure_threshold: int = 3,
                 cooldown_base_s: float = 0.25,
                 cooldown_max_s: float = 8.0,
                 ewma_alpha: float = 0.3,
                 redirect_memo_s: float = 1.0):
        self.endpoints: List[Endpoint] = [
            (str(h), int(p)) for (h, p) in endpoints]
        if not self.endpoints:
            raise ValueError("EndpointHealthCache needs >= 1 endpoint")
        self.seed = int(seed)
        self.failure_threshold = int(failure_threshold)
        self.cooldown_base_s = float(cooldown_base_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self.ewma_alpha = float(ewma_alpha)
        self.redirect_memo_s = float(redirect_memo_s)
        self._lock = threading.Lock()
        self._records: Dict[Endpoint, _EndpointRecord] = {
            ep: _EndpointRecord() for ep in self.endpoints}
        self._primary: Optional[Endpoint] = None

    # -- clock ---------------------------------------------------------------

    @staticmethod
    def _now(now: Optional[float]) -> float:
        return time.monotonic() if now is None else float(now)

    # -- routing -------------------------------------------------------------

    def order(self, *, write: bool = False,
              now: Optional[float] = None) -> List[Endpoint]:
        """Every endpoint, best-first.  Healthy circuits sort before
        probe-due ones before open ones; among healthy, a write prefers
        the believed primary, then fewer recent failures, then the
        rounded EWMA latency, then index.  Never empty — with every
        circuit open the least-bad endpoint still gets knocked on
        (refusing to try anything is strictly worse than probing)."""
        t = self._now(now)
        with self._lock:
            primary = self._primary

            def key(item):
                idx, ep = item
                rec = self._records[ep]
                if rec.open_until is None:
                    state = 0  # closed: healthy
                elif t >= rec.open_until:
                    state = 1  # cooldown elapsed: probe half-open
                else:
                    state = 2  # open: last resort
                primary_rank = 0 if (write and ep == primary) else 1
                # a write avoids endpoints that RECENTLY said not_leader
                # (the memo expires on the lease-TTL scale, so an
                # elected ex-standby gets re-knocked on soon enough)
                redirected = (write and rec.redirected_until is not None
                              and t < rec.redirected_until)
                lat = (float("inf") if rec.ewma_s is None
                       else round(rec.ewma_s, 2))
                return (state, primary_rank, int(redirected),
                        rec.consec_failures, lat, idx)

            ranked = sorted(enumerate(self.endpoints), key=key)
            first = ranked[0][1]
            rec = self._records[first]
            probing = (rec.open_until is not None and t >= rec.open_until)
            if probing:
                rec.probing = True
                obs.counter("client.endpoint_health.probes").inc()
        if probing:
            obs.event("client.endpoint_half_open", endpoint=list(first))
        return [ep for _, ep in ranked]

    def believed_primary(self) -> Optional[Endpoint]:
        with self._lock:
            return self._primary

    # -- outcome recording ---------------------------------------------------

    def record_success(self, ep: Endpoint, latency_s: Optional[float] = None,
                       now: Optional[float] = None) -> None:
        with self._lock:
            rec = self._records.get(ep)
            if rec is None:
                return
            reopened = rec.open_until is not None
            rec.successes += 1
            rec.consec_failures = 0
            rec.open_until = None
            rec.openings = 0
            rec.probing = False
            if latency_s is not None:
                lat = float(latency_s)
                rec.ewma_s = (lat if rec.ewma_s is None else
                              self.ewma_alpha * lat +
                              (1.0 - self.ewma_alpha) * rec.ewma_s)
        if reopened:
            obs.counter("client.endpoint_health.recovered").inc()
            obs.event("client.endpoint_recovered", endpoint=list(ep))

    def record_failure(self, ep: Endpoint,
                       now: Optional[float] = None) -> None:
        t = self._now(now)
        opened = False
        with self._lock:
            rec = self._records.get(ep)
            if rec is None:
                return
            was_probing = rec.probing
            rec.failures += 1
            rec.consec_failures += 1
            rec.probing = False
            if self._primary == ep:
                self._primary = None
            if rec.consec_failures >= self.failure_threshold:
                cooldown = cooldown_schedule(
                    self.seed, ep, rec.openings + 1,
                    base_s=self.cooldown_base_s,
                    max_s=self.cooldown_max_s)[rec.openings]
                rec.open_until = t + cooldown
                rec.openings += 1
                rec.consec_failures = 0
                opened = True
        obs.counter("client.endpoint_health.failures").inc()
        if was_probing:
            # a half-open probe that failed: the cooldown re-arms below
            obs.event("client.endpoint_probe_failed", endpoint=list(ep))
        if opened:
            obs.counter("client.endpoint_health.opened").inc()
            obs.event("client.endpoint_circuit_open", endpoint=list(ep))

    def record_redirect(self, ep: Endpoint,
                        now: Optional[float] = None) -> None:
        """A ``not_leader`` reply: the endpoint is ALIVE (it answered)
        but is not the primary — clear any stale primary belief and
        memo "not primary" for a lease-TTL-ish window, without dinging
        its health (reads still route here happily)."""
        t = self._now(now)
        with self._lock:
            rec = self._records.get(ep)
            if rec is not None:
                rec.consec_failures = 0
                rec.redirected_until = t + self.redirect_memo_s
            if self._primary == ep:
                self._primary = None
        obs.counter("client.endpoint_health.redirects").inc()
        obs.event("client.endpoint_redirected", endpoint=list(ep))

    def set_primary(self, ep: Endpoint) -> None:
        with self._lock:
            changed = self._primary != ep
            self._primary = ep
            rec = self._records.get(ep)
            if rec is not None:
                rec.redirected_until = None
        if changed:
            obs.event("client.primary_learned", endpoint=list(ep))

    # -- introspection -------------------------------------------------------

    def snapshot(self, now: Optional[float] = None) -> dict:
        t = self._now(now)
        with self._lock:
            return {
                "primary": (list(self._primary)
                            if self._primary is not None else None),
                "endpoints": {
                    f"{h}:{p}": {
                        "open": (rec.open_until is not None
                                 and t < rec.open_until),
                        "consec_failures": rec.consec_failures,
                        "openings": rec.openings,
                        "successes": rec.successes,
                        "failures": rec.failures,
                        "ewma_s": (None if rec.ewma_s is None
                                   else round(rec.ewma_s, 4)),
                    }
                    for (h, p), rec in self._records.items()},
            }

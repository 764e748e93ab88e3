"""Resident serving loop (port of ``serving/``, its in-process half).

Everything below this package is one-shot — ``panel.fit`` builds a plan,
walks it, and exits.  :class:`FitServer` is the long-lived caller the
journal, watchdog, elastic-lane, and obs planes were built for: a daemon
that admits concurrent tenant fit requests under bounded queues and
per-tenant quotas, coalesces compatible panels into micro-batched chunked
walks (demuxed per tenant, bitwise-identical to solo fits), enforces
per-request deadlines through the watchdog, sheds lowest-priority work
under overload with explicit retry-after rejections, quarantines failing
batches, keeps one process-level pinned staging pool warm across
requests, journals every batch so a SIGKILLed server resumes in-flight
work bitwise on restart, and streams its health and metrics through the
Prometheus-textfile sink (``obs.promsink``).  Every request is fitted on
the server's ``device`` (default ``"cuda"``), through the CUDA kernels.

Quickstart::

    from spark_timeseries_tpu_torch import serving

    with serving.FitServer("/srv/fits", max_batch_rows=8192,
                           prom_path="/metrics/fits.prom") as srv:
        ticket = srv.submit("tenant-a", y, "arima", order=(1, 1, 1),
                            deadline_s=30.0)
        res = ticket.result()          # TenantFitResult, rows == y rows
        res.status                     # per-row FitStatus, TIMEOUT capped

- :mod:`.session` — requests, tickets, results, the error vocabulary
  (:class:`RejectedError` with ``retry_after_s`` is the backpressure
  signal).
- :mod:`.admission` — the bounded queue, priority shedding, tenant
  quotas.
- :mod:`.batcher` — micro-batch packing/demux and the durable batch
  membership records recovery replays.
- :mod:`.server` — the :class:`FitServer` daemon itself.
- :mod:`.profiles` — :class:`TenantProfileStore`: durable per-tenant
  auto-fit profiles with TTL/count eviction; repeat tenants route to warm
  stepwise searches.
- :mod:`.tickloop` — :class:`TickLoop`: the tick-to-forecast streaming
  loop — record tick batch, idempotent shard append, delta-warm refit,
  forecast, publish through a write-back sink, all as one journaled cycle
  that resumes bitwise after SIGKILL.

- :mod:`.transport` — the length-prefixed socket wire protocol:
  CRC-framed (optionally HMAC-armed) messages carrying the durable
  npz+JSON request spelling verbatim, and :class:`TransportServer`, the
  per-replica socket front end.  The bytes are the reference's.
- :mod:`.client` — :class:`FitClient`: kill-tolerant remote access with
  idempotent resubmit on existing request ids, bounded deterministic
  backoff, per-call deadlines, and reconnect-safe result polling.  Host
  code: a tensor argument is read to the host once.
- :mod:`.health` — :class:`EndpointHealthCache`: the client's
  per-endpoint circuit breaker / primary belief / latency EWMA; writes
  prefer the believed primary, reads fan to healthy standbys, failing
  endpoints cool down on a seeded deterministic schedule.
- :mod:`.fleet` — :class:`FleetReplica`: N replicas on one checkpoint
  root under a lease/fencing protocol; a SIGKILLed primary's write-ahead
  requests are taken over and re-answered bitwise by a surviving peer,
  stale-token zombies lose loudly (:class:`FencedError`), standbys serve
  forecast reads from a private scratch root, leaderless windows answer
  typed ``read_only``, and a primary whose disk refuses writes steps
  down cleanly.  The device rides ``server_kwargs`` to each replica's
  ``FitServer``.
"""

from . import (admission, batcher, client, fleet, health, profiles, server,
               session, tickloop, transport)
from .admission import AdmissionQueue, TenantQuota
from .batcher import MicroBatch, batch_key
from .client import (ClientDeadlineError, FitClient, RemoteTicket,
                     backoff_schedule)
from .fleet import FleetReplica, discover_endpoints
from .health import EndpointHealthCache, cooldown_schedule
from .profiles import TenantProfileStore
from .server import FORECAST_MODEL, FitServer
from .session import (CancelledError, FitRequest, FitTicket, RejectedError,
                      ServerClosedError, StorageError, TenantFitResult)
from .tickloop import CycleResult, TickLoop, TickLoopError
from .transport import (FrameError, NotLeaderError, ReadOnlyError,
                        TransportError, TransportServer, WireAuthError,
                        resolve_wire_secret)

__all__ = [
    "AdmissionQueue",
    "CancelledError",
    "ClientDeadlineError",
    "CycleResult",
    "EndpointHealthCache",
    "FORECAST_MODEL",
    "FitClient",
    "FitRequest",
    "FitServer",
    "FitTicket",
    "FleetReplica",
    "FrameError",
    "MicroBatch",
    "NotLeaderError",
    "ReadOnlyError",
    "RejectedError",
    "RemoteTicket",
    "ServerClosedError",
    "StorageError",
    "TenantFitResult",
    "TenantProfileStore",
    "TenantQuota",
    "TickLoop",
    "TickLoopError",
    "TransportError",
    "TransportServer",
    "WireAuthError",
    "admission",
    "backoff_schedule",
    "batch_key",
    "batcher",
    "client",
    "cooldown_schedule",
    "discover_endpoints",
    "fleet",
    "health",
    "profiles",
    "resolve_wire_secret",
    "server",
    "session",
    "tickloop",
    "transport",
]

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

The reference's socket transport, remote client, endpoint health cache
and replica fleet (``transport``, ``client``, ``health``, ``fleet``) are
not ported yet.
"""

from . import admission, batcher, profiles, server, session, tickloop
from .admission import AdmissionQueue, TenantQuota
from .batcher import MicroBatch, batch_key
from .profiles import TenantProfileStore
from .server import FORECAST_MODEL, FitServer
from .session import (CancelledError, FitRequest, FitTicket, RejectedError,
                      ServerClosedError, StorageError, TenantFitResult)
from .tickloop import CycleResult, TickLoop, TickLoopError

__all__ = [
    "AdmissionQueue",
    "CancelledError",
    "CycleResult",
    "FORECAST_MODEL",
    "FitRequest",
    "FitServer",
    "FitTicket",
    "MicroBatch",
    "RejectedError",
    "ServerClosedError",
    "StorageError",
    "TenantFitResult",
    "TenantProfileStore",
    "TenantQuota",
    "TickLoop",
    "TickLoopError",
    "admission",
    "batch_key",
    "batcher",
    "profiles",
    "server",
    "session",
    "tickloop",
]

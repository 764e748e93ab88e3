"""Resilient fit execution: the batch analog of Spark task retry (port of
``reliability/``).

A NaN-poisoned executor task was re-run elsewhere by Spark; here a fit is
one batched call over many rows, so this package rebuilds the same
guarantees at row granularity:

- :mod:`.status` — the per-row :class:`FitStatus` vocabulary every public
  ``fit`` reports.
- :mod:`.sanitize` — input repair/rejection (NaN/Inf/constant/all-NaN)
  with an impute / exclude / raise policy.
- :mod:`.runner` — :func:`resilient_fit`: sanitize, fit, then a retry ->
  fallback ladder over the failed subset (perturbed inits, the
  conservative settings) before any row is marked ``DIVERGED``.
- :mod:`.chunked` — :func:`fit_chunked`: the journaled chunk walk, with
  bounded out-of-memory backoff and degradation recorded in metadata.
- :mod:`.plan` — :class:`ExecutionPlan` / :class:`LaneRunner`: the walk's
  configuration as data and the lane scheduler that owns one prefetch →
  compute → commit pipeline, plus the allocation-failure classifier
  :func:`is_resource_exhausted`.
- :mod:`.committer` — :class:`ChunkCommitter`: the bounded background
  commit thread (journal commits and host I/O overlap the next chunk's
  kernels, in order, one writer).
- :mod:`.prefetcher` — :class:`ChunkPrefetcher`: the input half of the
  pipeline, staging chunk N+1 on its own CUDA stream while chunk N
  computes.
- :mod:`.source` — :class:`ChunkSource`: where the panel's rows live
  (a tensor, host ``np.ndarray``, npz or parquet shard directories), so
  a panel that never fully resides on the card walks through pinned
  staging buffers at O(chunk) device footprint.
- :mod:`.sink` — :class:`~.sink.WritableChunkSource`: committed results
  stream out as durable output shards.
- :mod:`.journal` — :class:`ChunkJournal`: write-ahead per-chunk npz
  shards + an atomic JSON manifest, so a journaled walk survives process
  death and resumes bitwise-identical; and the fleet lease protocol.
- :mod:`.delta` — delta walks: refit only the chunks whose rows changed.
- :mod:`.watchdog` — :func:`call_with_deadline` / :class:`Deadline`:
  wall-clock budgets for a fit call and for a whole job.
- :mod:`.faultinject` — deterministic data, behavioral, commit, disk,
  lane, request and wire faults that drive every recovery path in tests.
- :mod:`.chaos` — seeded chaos scenarios against a replica fleet: timed
  schedules of composed faults, a runner, the invariant checker
  (conservation, bitwise re-answers, monotonic fencing, bounded
  unavailability), and the durable ``chaos_manifest.json`` record.

``fit_chunked(..., shard=True | mesh=)`` is the multi-lane walk: one lane
per series-axis device of a mesh (:class:`LaneSupervisor` over a
:class:`WorkQueue` makes a single-process one elastic), per-shard journal
namespaces read across by :class:`ShardJournalView`, and one merged root
manifest (:func:`merge_job_manifest`).
"""

from . import (chaos, chunked, committer, delta, faultinject, journal, plan,
               prefetcher, runner, sanitize, sink, source, status, watchdog)
from .chaos import (ChaosEvent, ChaosRunner, InvariantViolation,
                    chaos_schedule, check_invariants, load_chaos_manifest,
                    unavailability_windows, write_chaos_manifest)
from .chunked import OOMBackoffExceeded, fit_chunked, is_resource_exhausted
from .committer import ChunkCommitter, CommitterStats
from .delta import (DeltaError, DeltaPlan, StalePriorError, WarmstartFit,
                    plan_delta)
from .journal import (ChunkJournal, FencedError, JournalError, Lease,
                      LeaseError, MergeWarmer, ShardJournalView,
                      StaleJournalError, TornManifestError, acquire_lease,
                      config_hash, merge_job_manifest, panel_fingerprint,
                      read_lease)
from .plan import (ExecutionPlan, LaneRunner, LaneSpec, LaneSupervisor,
                   RestagedPanel, WorkQueue, shard_spans)
from .prefetcher import ChunkPrefetcher, PrefetchStats
from .runner import (ResilientFitResult, RetryRung, default_ladder,
                     resilient_fit)
from .sanitize import SanitizeReport, sanitize
from .sink import SinkError, WritableChunkSource
from .source import (ChunkSource, DeviceChunkSource, HostChunkSource,
                     NpzShardSource, SourceError, StagingPool, as_source,
                     write_npz_shards)
from .status import STATUS_DTYPE, FitStatus, merge_status, status_counts
from .watchdog import Deadline, DeadlineExceeded, call_with_deadline

__all__ = [
    "ChaosEvent",
    "ChaosRunner",
    "ChunkCommitter",
    "ChunkJournal",
    "ChunkPrefetcher",
    "ChunkSource",
    "CommitterStats",
    "Deadline",
    "DeadlineExceeded",
    "DeltaError",
    "DeltaPlan",
    "DeviceChunkSource",
    "ExecutionPlan",
    "FencedError",
    "FitStatus",
    "HostChunkSource",
    "InvariantViolation",
    "JournalError",
    "LaneRunner",
    "LaneSpec",
    "LaneSupervisor",
    "Lease",
    "LeaseError",
    "MergeWarmer",
    "NpzShardSource",
    "OOMBackoffExceeded",
    "PrefetchStats",
    "ResilientFitResult",
    "RestagedPanel",
    "RetryRung",
    "STATUS_DTYPE",
    "SanitizeReport",
    "ShardJournalView",
    "SinkError",
    "SourceError",
    "StagingPool",
    "StaleJournalError",
    "StalePriorError",
    "TornManifestError",
    "WarmstartFit",
    "WorkQueue",
    "WritableChunkSource",
    "acquire_lease",
    "as_source",
    "call_with_deadline",
    "chaos",
    "chaos_schedule",
    "check_invariants",
    "chunked",
    "committer",
    "config_hash",
    "default_ladder",
    "delta",
    "faultinject",
    "fit_chunked",
    "is_resource_exhausted",
    "journal",
    "load_chaos_manifest",
    "merge_job_manifest",
    "merge_status",
    "panel_fingerprint",
    "plan",
    "plan_delta",
    "prefetcher",
    "read_lease",
    "resilient_fit",
    "runner",
    "sanitize",
    "shard_spans",
    "sink",
    "source",
    "status",
    "status_counts",
    "unavailability_windows",
    "watchdog",
    "write_chaos_manifest",
    "write_npz_shards",
]

"""Chunked fit execution: pipelined commits, OOM backoff, journal, watchdog
(port of ``reliability/chunked.py``, its single-lane walk).

The north-star workload (1M series x 1k obs) cannot always fit one
monolithic batch on the card — and the right chunk size depends on the
model, the dtype, and what else is resident on the device.  Rather than
making the caller guess, :func:`fit_chunked` walks the panel in row chunks
and treats an allocation failure as a recoverable signal: the chunk size is
halved (bounded retries) and the degradation is recorded in the result
metadata, the batch analog of Spark re-running a too-big task after an
executor OOM.

Only allocation failures trigger backoff; every other error propagates
unchanged (halving a chunk cannot fix a shape bug, and silently retrying
would bury it).  Nothing here catches a kernel build or launch failure.

Above the backoff sit the two *job-level* durability layers Spark provided
for free and a single Python process does not:

- ``checkpoint_dir=`` attaches a write-ahead **chunk journal**
  (:mod:`.journal`): every finished chunk is committed as an npz shard
  plus an atomically updated manifest, and a restarted run SKIPS committed
  chunks, producing results bitwise-identical to an uninterrupted run.
- ``chunk_budget_s=`` / ``job_budget_s=`` arm the **deadline watchdog**
  (:mod:`.watchdog`): a chunk that overruns its wall-clock budget is
  marked ``FitStatus.TIMEOUT`` (rows NaN, journal entry ``TIMEOUT``) and
  the walk continues; once the job budget is spent, remaining chunks are
  marked TIMEOUT without dispatch.  A later resume retries only the
  TIMEOUT/pending chunks.

**Pipelined execution** (``pipeline=True``, the default): finished chunks
are handed to a bounded background committer
(:class:`~.committer.ChunkCommitter`) that preserves the journal's
single-writer, shard-before-manifest, in-order protocol while the driver
thread is already launching the next chunk; a background
:class:`~.prefetcher.ChunkPrefetcher` stages chunk N+1 on its own CUDA
stream while chunk N computes, under a static align-mode plan computed
once per walk.  The steady state is stage N+1 ∥ compute N ∥ commit N−1,
results are bitwise-identical to ``pipeline=False``, and
``meta["pipeline"]`` reports how much commit and staging wall the overlap
hid.

**Host-resident panels**: passing a :class:`~.source.ChunkSource` instead
of a tensor (host ``np.ndarray`` via ``HostChunkSource``, an npz shard
directory via ``NpzShardSource``, or anything ``as_source`` coerces) walks
a panel that NEVER fully resides on the card: each chunk is copied to the
device through the source's pool of pinned host buffers, and the staged
tensor is donated back to the caching allocator the moment its chunk's fit
has consumed it, so steady-state device footprint is O(chunk), not
O(panel).  The staged bytes are exactly ``panel[lo:hi]``, so the
host-resident walk is bitwise-identical to the in-memory walk and journals
cross-resume between residencies.

**Device**: a tensor ``y`` is walked where it lives; any other panel goes
to ``fit_kwargs["device"]`` (default ``"cuda"``, as every entry point)
whole — the in-memory walk — and a source stages each chunk there.

**Sharded execution** (``shard=True`` or an explicit ``mesh=``): the
walk's configuration is compiled into an :class:`~.plan.ExecutionPlan`
whose lanes partition the CHUNK GRID contiguously across the mesh's
series-axis devices, and one :class:`~.plan.LaneRunner` per shard — each
with its own journal namespace, committer and prefetcher, on its own
thread and CUDA stream — walks its span concurrently while the job
deadline and the obs registry stay shared.  Shard boundaries always land
on the single-lane walk's chunk boundaries, so the sharded result is
bitwise-identical to the single-lane walk on the same panel; shard/process
0 merges the per-shard manifests into ONE job manifest
(``journal.merge_job_manifest``).  A single-process sharded walk is
elastic (:class:`~.plan.LaneSupervisor`).  Under a ``torch.distributed``
group each process runs the lanes of its own cells (build the panel with
``parallel.mesh.distribute_panel``) and returns its local rows.
"""

from __future__ import annotations

import functools
import inspect
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs
from ..parallel import mesh as meshlib
from . import delta as delta_mod
from . import journal as journal_mod
from . import plan as plan_mod
from . import sink as sink_mod
from . import source as source_mod
from . import watchdog as watchdog_mod
from .plan import (ExecutionPlan, LaneRunner, LaneSpec, OOMBackoffExceeded,
                   _TimeoutChunk, _piece_status, is_resource_exhausted)
from .runner import ResilientFitResult, _accepted_kwargs, _host
from .status import STATUS_DTYPE, FitStatus, status_counts

__all__ = ["OOMBackoffExceeded", "is_resource_exhausted", "fit_chunked"]

def _explicit_align_param(fn) -> bool:
    try:
        return "align_mode" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


@obs.dump_on_failure("fit_chunked")
def fit_chunked(
    fit_fn: Callable,
    y,
    *,
    chunk_rows: Optional[int] = None,
    min_chunk_rows: int = 256,
    max_backoffs: int = 8,
    resilient: bool = True,
    policy: str = "impute",
    ladder=None,
    checkpoint_dir: Optional[str] = None,
    resume: str = "auto",
    chunk_budget_s: Optional[float] = None,
    job_budget_s: Optional[float] = None,
    pipeline: bool = True,
    pipeline_depth: int = 2,
    prefetch_depth: int = 1,
    align_mode: Optional[str] = None,
    mesh=None,
    shard: bool = False,
    lane_retries: int = 1,
    lane_retry_backoff_s: float = 0.1,
    rebalance_threshold: float = 4.0,
    process_index: Optional[int] = None,
    grid: Optional[tuple] = None,
    delta_from: Optional[str] = None,
    delta_warmstart: bool = True,
    sink=None,
    journal_extra: Optional[dict] = None,
    _journal_commit_hook=None,
    **fit_kwargs,
) -> ResilientFitResult:
    """Fit ``y [B, T]`` in row chunks of at most ``chunk_rows``.

    ``y`` is a tensor (walked on its device), an array-like (moved whole
    to ``fit_kwargs["device"]``, default ``"cuda"``) — or a
    :class:`~.source.ChunkSource` for panels that must NOT fully reside on
    the device (host RAM, npz shard directories): the walk then stages each
    chunk to the device through the source's staging pool as it arrives,
    at the same chunk boundaries, producing bitwise-identical results
    (``meta["source"]`` and ``meta["pipeline"]["staging_pool"]`` carry the
    staging accounting, and sources without an explicit ``chunk_rows``
    default to the source's natural chunking, e.g. npz shard size).

    Each chunk runs through :func:`~.runner.resilient_fit` (sanitize +
    retry ladder) unless ``resilient=False``, in which case ``fit_fn`` is
    called directly and per-row status comes from the model's own status
    output.  On an allocation failure (``torch.cuda.OutOfMemoryError`` or
    the simulated ``RESOURCE_EXHAUSTED``) the chunk size halves (never
    below ``min_chunk_rows``) and the chunk is retried, at most
    ``max_backoffs`` times; exhausting the budget (or failing at the floor)
    raises :class:`OOMBackoffExceeded`.  The failed chunk's exception and
    traceback are dropped before the retry, so the failed fit's tensors
    are free.

    **Durability** (``checkpoint_dir=``): finished chunks are committed to
    a write-ahead journal (:class:`~.journal.ChunkJournal`) — npz shard
    first, then an atomic manifest update recording the row range, per-row
    ``FitStatus`` counts, wall time, peak device memory, and the run's
    config hash / panel fingerprint.  A restarted call with the same panel
    and config (``resume="auto"``, the default) loads committed chunks
    from their shards and recomputes only what is missing, so the final
    result is bitwise-identical to an uninterrupted run; a journal written
    under a different panel or config is rejected
    (:class:`~.journal.StaleJournalError`), as is a torn manifest
    (:class:`~.journal.TornManifestError`) — under EVERY resume mode.
    ``resume="never"`` reruns the same job from scratch, ignoring its
    committed chunks; ``"require"`` demands a resumable manifest.

    **Pipelining** (``pipeline=True``, default): with a journal attached,
    the host fetch + shard write + manifest update of a finished chunk run
    on a background committer thread (at most ``pipeline_depth`` commits
    in flight, in order) while the driver launches the next chunk.  The
    pipeline changes WHERE the commit I/O happens, never what is
    computed: results are bitwise-identical to ``pipeline=False``, and a
    crash with commits in flight resumes exactly as a serial crash would.
    The pipeline knobs are EXCLUDED from the journal's config hash.
    ``meta["pipeline"]`` reports the commit wall time, how much of it the
    driver never waited for (``hidden_commit_s``), and the resulting
    ``overlap_efficiency``.

    **Input staging**: while chunk N computes, a background
    :class:`~.prefetcher.ChunkPrefetcher` stages chunk N+1 (at most
    ``prefetch_depth`` chunks ahead, default 1) on its own CUDA stream.
    The staged chunk is the SAME ``panel[lo:hi]`` the serial driver
    takes; the driver predicts the next span on the committed grid and
    invalidates staged chunks whenever OOM backoff or a committer rollback
    re-chunks the walk, so a stale prediction degrades to an inline slice,
    never a wrong one.  ``prefetch_depth=0`` (or ``pipeline=False``)
    disables staging.  ``meta["pipeline"]`` gains ``staging_wall_s`` /
    ``hidden_staging_s`` / ``input_overlap_efficiency`` and the combined
    ``end_to_end_overlap_efficiency``.

    **Static align-mode plan**: when ``fit_fn`` names an ``align_mode``
    parameter (every bundled model fit does), a sliced walk computes the
    panel's alignment mode ONCE and passes it to every chunk fit, so no
    chunk pays its own NaN probe.  The panel-level mode is a row-wise
    property, so it is exact for every row slice.  Pass ``align_mode=`` to
    skip even the one probe (the journal's config hash covers the resolved
    mode, so a resumed run must use the same plan).  ``meta["align_mode"]``
    records the plan.

    **Deadlines**: ``chunk_budget_s`` bounds each chunk's fit (overrun ->
    rows flagged ``TIMEOUT``, walk continues — the computation is
    abandoned, not cancelled; with the budget armed, non-resilient fits
    synchronize their stream inside the watchdog window so the budget
    covers the kernels, not just their launch); ``job_budget_s`` bounds
    the whole walk (once spent, remaining chunks are marked TIMEOUT without
    dispatch).  Both paths drain the commit queue before touching the
    journal, so the TIMEOUT mark always lands after every earlier commit.

    ``meta`` records ``chunk_rows_initial`` / ``chunk_rows_final``, every
    backoff and timeout event, ``degraded=True`` whenever a backoff or
    timeout happened, and — when journaled — the journal accounting
    (``meta["journal"]``: run id, chunks committed/resumed/timeout).

    **Delta walks** (``delta_from=PRIOR_ROOT``): refit only what changed.
    The planner (:mod:`.delta`) diffs this panel against the committed
    journal at ``PRIOR_ROOT`` using the per-chunk content fingerprints
    every version-2 manifest records: unchanged chunks (**clean**) are
    spliced into this walk's NEW journal as ordinary commits up front —
    zero compute — so the resume machinery skips them; chunks whose
    history GREW with a byte-identical prefix (**warm**) refit
    warm-started from the journaled params via augmented init-param
    columns (:class:`~.delta.WarmstartFit`; requires ``resilient=False``
    and a fit with ``init_params=``); revised/new chunks refit in full.
    A same-length delta is bitwise-identical to the cold walk of the new
    panel on the same chunk grid; ``delta_warmstart=False`` refits
    everything cold, pinning the WHOLE result bitwise against the cold
    walk.  Requires ``checkpoint_dir=``.  ``meta["delta"]`` reports the
    class counts.

    **Grid coordinate** (``grid=(index, total)`` or ``(index, total,
    members)``): places this walk on an order search's grid; a label on
    spans, events and the manifest (``extra.grid``), NOT part of the
    journal config hash.

    **Write-back sink** (``sink=`` a directory or a
    :class:`~.sink.WritableChunkSource`): every committed chunk's arrays
    stream out as durable output shards instead of concatenating in host
    RAM; the result's arrays are then None and ``meta["sink"]`` carries
    the accounting.  Requires ``checkpoint_dir=``.

    **Telemetry** (``obs.enable()``): each chunk dispatch runs under an
    ``obs.span("chunk")``; backoffs, timeouts, and per-row status totals
    feed the metrics registry; the per-run summary lands in
    ``meta["telemetry"]`` and, when journaled, the manifest's
    ``telemetry`` block.  Disabled (the default), none of this runs and
    the result is bitwise-identical to the uninstrumented driver.

    **Sharded execution** (``shard=True`` or ``mesh=``): the chunk grid is
    partitioned contiguously across the mesh's series-axis devices
    (:func:`~.plan.shard_spans` — every shard owns whole chunks, so shard
    boundaries ARE single-lane chunk boundaries) and one lane per shard
    walks its span concurrently, a thread on its cell's device inside a
    CUDA stream of its own (``parallel.mesh.lane_values`` places the
    rows: a row view where the lane's device is the panel's).  A mesh may
    list one card several times: several lanes then share it.  With
    ``shard=True`` and no ``chunk_rows``, each shard gets one chunk.
    Journaled sharded walks commit into per-shard namespaces
    (``shard_00000/…``) and shard/process 0 merges them into ONE
    ``manifest.json`` (a ``shards`` block, shard-tagged chunk entries,
    ``merged_from_shards``) after the lanes join; a resume rebuilds the
    same lanes and replays only uncommitted chunks.  ``meta["shards"]``
    records the lane layout; ``meta["pipeline"]`` aggregates the lanes and
    reports per-shard overlap in ``meta["pipeline"]["shards"]``.
    ``sink=`` is refused with a sharded walk.

    **Elastic lanes** (single-process sharded walks): a lane whose walk
    raises is retried up to ``lane_retries`` times with exponential
    backoff (``lane_retry_backoff_s``), then QUARANTINED — its uncommitted
    chunks are re-staged to survivors' devices and recomputed, its
    committed chunks adopted from its journal namespace.  Idle lanes STEAL
    the grid-aligned tail of a straggler's span once its projected finish
    exceeds ``rebalance_threshold`` mean chunk walls.  Results stay
    bitwise-identical to the single-lane walk whichever lane computed a
    chunk; a job that loses ALL lanes fails with the original error.
    ``meta["shards"]["elastic"]`` records quarantines, steals and retries.

    **Several processes**: under a ``torch.distributed`` group (see
    ``parallel.mesh.init_distributed``) each process runs the lanes of its
    own cells, a source-backed walk is refused, lanes are not elastic (a
    process cannot re-stage another's rows), ``process_index`` defaults to
    the process's rank, and the processes meet at a best-effort barrier
    (``torch.distributed.barrier``) before process 0 merges the manifest.
    Each returns its local rows.
    """
    device = fit_kwargs.get("device", "cuda")

    # -- chunk source --------------------------------------------------------
    # `y` may be a ChunkSource instead of a tensor: the panel then lives
    # wherever the source says (host RAM, an npz shard directory) and every
    # chunk is staged to the device through the source's pinned staging
    # pool as the walk reaches it — the panel NEVER fully resides on the
    # device.  A DeviceChunkSource unwraps to the tensor walk.
    src = None
    chunk_rows_from_source = False
    if isinstance(y, source_mod.ChunkSource):
        if isinstance(y, source_mod.DeviceChunkSource):
            yb = y.array
        else:
            src = y
            yb = None
            if chunk_rows is None and src.default_chunk_rows:
                chunk_rows_from_source = True
                # sources know their natural chunking — shard size for
                # npz dirs, a bounded slice for host arrays — and the
                # grid lands there unless the caller says otherwise
                chunk_rows = src.default_chunk_rows
    elif isinstance(y, torch.Tensor):
        yb = y
    elif getattr(y, "is_distributed_panel", False):
        # this process's share of a group's panel (parallel.mesh
        # .distribute_panel): its blocks are the lanes it runs
        yb = y
    else:
        from ..models.base import to_device  # it imports this package

        yb = to_device(y, device)
    if src is not None:
        b, t_len = src.shape
        panel_dtype = src.dtype
        src_stats0 = src.stats()
        # peak_live_device_bytes must be THIS walk's high-water mark
        src.reset_peak_live()
    else:
        if yb.ndim != 2:
            raise ValueError(
                f"fit_chunked expects [batch, time], got {tuple(yb.shape)}")
        b = int(yb.shape[0])
        t_len = int(yb.shape[1])
        panel_dtype = np.dtype(str(yb.dtype).replace("torch.", ""))
    distributed = getattr(yb, "is_distributed_panel", False)

    # -- delta walk ----------------------------------------------------------
    # delta_from= diffs THIS panel against a committed prior journal
    # (reliability.delta): unchanged chunks are spliced into the new
    # journal as ordinary commits up front (zero compute — the resume
    # machinery then skips them), grown-history chunks refit warm-started
    # from the journaled params via augmented init columns, and only the
    # revised/new remainder refits cold.
    delta_plan = None
    delta_wrapped = False
    data_cols = None
    # placement-independent identity of the INNER fit (the model + its
    # kwargs, align/driver knobs excluded), recorded in every journaled
    # manifest (`extra.fit`) and checked before a warm delta splices
    # another job's params in as inits
    fit_base = journal_mod.config_hash(
        fit_fn, {k: v for k, v in fit_kwargs.items() if k != "align_mode"})
    _inner = fit_fn
    while isinstance(_inner, functools.partial):
        _inner = _inner.func
    fit_name = (getattr(_inner, "__module__", "?") + "."
                + getattr(_inner, "__qualname__", repr(_inner)))
    if delta_from is not None:
        if checkpoint_dir is None:
            raise ValueError(
                "delta_from= requires checkpoint_dir=: the delta walk "
                "journals adopted + recomputed chunks into a NEW namespace")
        if meshlib.process_count() > 1 or distributed:
            raise ValueError(
                "delta walks are single-process (the planner streams the "
                "panel's rows on the host to fingerprint each chunk)")
        # only a CALLER-chosen chunk_rows constrains the delta grid: a
        # source's natural chunking (npz shard size) must not preempt
        # the prior walk's grid
        delta_plan = delta_mod.plan_delta(
            delta_from, src if src is not None else yb,
            chunk_rows=None if chunk_rows_from_source else chunk_rows,
            warmstart=delta_warmstart)
        # the prior walk's grid: delta identity is per-chunk, so the
        # grids must align for adoption to mean anything
        chunk_rows = delta_plan.chunk_rows
        data_cols = t_len  # the new walk's fingerprints cover the raw data
        if delta_plan.counts["warm"] and delta_warmstart:
            pfit = ((delta_plan.manifest.get("extra") or {})
                    .get("fit") or {})
            if pfit.get("base_config") and \
                    pfit["base_config"] != fit_base:
                raise delta_mod.StalePriorError(
                    f"prior journal {delta_plan.prior_dir} fitted "
                    f"{pfit.get('name')} under a different model "
                    "configuration; its params cannot warm-start this "
                    "fit — refit from scratch or point delta_from at a "
                    "journal of the SAME fit/kwargs")
            if resilient:
                raise ValueError(
                    "a warm-started delta walk must run resilient=False "
                    "(the sanitizer would 'repair' the init-param "
                    "columns); pass resilient=False, or "
                    "delta_warmstart=False for an exact cold delta")
            try:
                _fit_params = inspect.signature(fit_fn).parameters
            except (TypeError, ValueError):
                _fit_params = {}
            for need in ("init_params", "align_mode"):
                if need not in _fit_params:
                    raise TypeError(
                        "delta_warmstart=True needs a fit_fn with an "
                        f"explicit {need}= parameter (the arima family "
                        "has one); pass delta_warmstart=False for an "
                        "exact cold delta")
            if align_mode is None:
                # resolved on the RAW panel before augmentation: the init
                # columns carry NaN on dirty/new rows, which would
                # otherwise downgrade the plan to "general" for data the
                # fit never sees unaligned
                from ..models import base as _model_base

                align_mode = (src.align_mode() if src is not None
                              else _model_base.align_mode_on_host(yb))
            fit_fn = delta_mod.WarmstartFit(fit_fn, t_len, delta_plan.k)
            aug = delta_mod.warm_panel(src if src is not None else yb,
                                       delta_plan.init)
            delta_wrapped = True
            if isinstance(aug, source_mod.ChunkSource):
                src = aug
                b, t_len = src.shape
                panel_dtype = src.dtype
                src_stats0 = src.stats()
                src.reset_peak_live()
            else:
                yb = aug
                b = int(yb.shape[0])
                t_len = int(yb.shape[1])

    # -- lane layout (the sharded half of the ExecutionPlan) -----------------
    # resolved BEFORE the align plan and the journal: the shard count can
    # pick the default chunk size, and lane placement is the mesh plane's
    # data distribution step
    use_mesh = mesh
    if use_mesh is None and shard:
        use_mesh = meshlib.default_mesh()
    n_shards = 1
    if use_mesh is not None:
        n_shards = len(meshlib.series_devices(use_mesh))
        if chunk_rows is None and n_shards > 1:
            # shard=True without a chunk size: one chunk per shard — the
            # coarsest layout that still gives every device a lane
            chunk_rows = -(-b // n_shards)
    chunk = int(chunk_rows) if chunk_rows else b
    chunk = max(1, min(chunk, b))
    chunk0 = chunk

    spans = [(0, b)]
    lanes = None  # [(shard_id, lo, hi, device, lane_values), ...]
    if use_mesh is not None and n_shards > 1:
        spans = list(plan_mod.shard_spans(b, chunk0, n_shards))
        if len(spans) > 1:
            if src is not None:
                # source-backed lanes need no device placement up front:
                # each lane stages ONLY its own spans to its device as its
                # walk reaches them.  Host RAM is process-local, so a
                # source-backed sharded walk is SINGLE-process — enforced
                # here, before any journal namespace is opened
                if meshlib.process_count() > 1:
                    raise ValueError(
                        "sharded walks over a ChunkSource are "
                        "single-process (host RAM/disk is process-local); "
                        "under torch.distributed build the panel with "
                        "parallel.mesh.distribute_panel instead of a source")
                devs = meshlib.series_devices(use_mesh)
                lanes = [(sid, slo, shi, devs[sid],
                          source_mod.SourceLane(src, base=slo,
                                                device=devs[sid]))
                         for sid, (slo, shi) in enumerate(spans)]
            else:
                try:
                    lanes = meshlib.lane_values(yb, use_mesh, spans)
                except BaseException:
                    # lane placement fails per process: on a journaled job
                    # the OTHER processes will block in the pre-merge
                    # barrier — join it so the error surfaces instead of
                    # hanging the survivors
                    if checkpoint_dir is not None:
                        _distributed_barrier()
                    raise
    sharded = lanes is not None
    if not sharded:
        if distributed:
            raise ValueError(
                "a distributed panel walks on its mesh: pass the mesh= its "
                "blocks were placed on (parallel.mesh.distribute_panel), "
                "with a chunk_rows whose grid has a lane per device")
        spans = [(0, b)]
        lanes = [(0, 0, b, None,
                  source_mod.SourceLane(src, device=device)
                  if src is not None else yb)]

    # static align-mode plan: resolve the panel's alignment mode ONCE (or
    # take the caller's hint) and pass it to every chunk fit — the
    # per-chunk NaN probe (one host read per sliced chunk) disappears.
    # Injected BEFORE the journal's config hash is computed: a resume must
    # run the same plan.
    from ..models import base as model_base

    fit_takes_align = "align_mode" in _accepted_kwargs(
        fit_fn, {"align_mode": None})
    if align_mode is not None:
        # a caller-provided hint is an explicit opt-in: a **kwargs fit_fn
        # is trusted to forward it (the caller asserted it can)
        if not fit_takes_align:
            raise TypeError(
                "align_mode= was given but fit_fn does not accept an "
                "align_mode keyword (the hint would be silently dropped)")
        fit_kwargs = {**fit_kwargs,
                      "align_mode": model_base.resolve_align_mode(
                          yb if src is None else src, align_mode)}
    elif (_explicit_align_param(fit_fn)
          and (src is not None or chunk < b or sharded)
          and "align_mode" not in fit_kwargs):
        # AUTO-injection requires align_mode as an explicitly NAMED
        # parameter — a bare **kwargs does not count (a third-party fit
        # forwarding to a strict solver would blow up on, or silently
        # absorb, a keyword it never asked for).  Only sliced walks
        # benefit; a SOURCE walk probes on the HOST (streamed through the
        # source: the panel never touches the device for the probe).  A
        # sharded walk always slices, so it always plans; a distributed
        # panel's processes agree on the weakest mode of their blocks.
        fit_kwargs = {**fit_kwargs,
                      "align_mode": (
                          src.align_mode() if src is not None
                          else yb.align_mode() if distributed
                          else model_base.align_mode_on_host(yb))}
    plan_mode = fit_kwargs.get("align_mode") if fit_takes_align else None

    # -- grid coordinate -----------------------------------------------------
    # an order search runs one ordinary walk per candidate order (or per
    # fusion group); grid=(index, total) or (index, total, members) places
    # this walk on that grid.  NOT config-hashed — purely a label.
    grid_members = None
    if grid is not None:
        gi, gn = (int(grid[0]), int(grid[1]))
        if not (0 <= gi < gn):
            raise ValueError(f"grid index {gi} out of range for total {gn}")
        if len(grid) > 2 and grid[2] is not None:
            grid_members = [int(m) for m in grid[2]]
            if any(not (0 <= m < gn) for m in grid_members) \
                    or grid_members[0] != gi:
                raise ValueError(
                    f"grid members {grid_members} must sit in [0, {gn}) "
                    f"and lead with the walk's own index {gi}")
        grid = (gi, gn)
        gx = {"index": gi, "total": gn}
        if grid_members is not None:
            gx["fused"] = grid_members
        journal_extra = {**(journal_extra or {}), "grid": gx}

    # -- journal -------------------------------------------------------------
    if src is not None:
        # the source spelling rides in the manifest `extra` (NOT the config
        # hash: an in-memory journal resumes under a host-RAM walk and vice
        # versa, both fingerprinting sampled VALUES; npz shard dirs
        # fingerprint by shard identity and so journal in their own domain)
        journal_extra = {**(journal_extra or {}),
                         "source": {"kind": src.kind,
                                    "panel_bytes": int(src.nbytes)}}
    # -- write-back sink -----------------------------------------------------
    # results stream OUT as durable output shards instead of concatenating
    # in host RAM; the sink moves I/O only — like the pipeline knobs it is
    # NOT part of the journal's config hash
    if sink is not None:
        if checkpoint_dir is None:
            raise ValueError(
                "sink= streams committed chunks out, so it requires a "
                "journaled walk: pass checkpoint_dir= as well")
        if sharded:
            raise ValueError(
                "sink= is not supported with shard=True/mesh=: output "
                "shards are named by global row span and a merged "
                "multi-lane sink is not implemented")
        if isinstance(sink, (str, os.PathLike)):
            sink = sink_mod.WritableChunkSource(sink)
        journal_extra = {**(journal_extra or {}),
                         "sink": {"directory": sink.directory,
                                  "depth": sink.depth}}
    journals = None
    cfg = fp = None
    if checkpoint_dir is not None:
        if data_cols is None:
            data_cols = t_len
        journal_extra = {
            **(journal_extra or {}),
            "panel": {"bytes": int(b) * int(t_len) * panel_dtype.itemsize,
                      "time": int(t_len), "dtype": str(panel_dtype)},
            # how many leading DATA columns the per-chunk fingerprints
            # cover — a warm delta walk's init columns are excluded
            "chunk_fp_cols": int(data_cols),
            # the INNER fit's identity (warm-wrapped walks record the
            # wrapped model, not the wrapper)
            "fit": {"name": fit_name, "base_config": fit_base}}
        if delta_plan is not None:
            journal_extra["delta"] = delta_mod.delta_extra(
                delta_plan, warmstart=delta_wrapped, data_cols=data_cols)
        if process_index is None:
            process_index = meshlib.process_index()
        # pipeline/shard knobs deliberately NOT hashed: they move I/O and
        # work between threads and devices without changing a byte of the
        # result, so a serial journal resumes under a pipelined run (and
        # the other way round), and a merged sharded manifest is adopted
        # by a later single-lane walk
        cfg = journal_mod.config_hash(
            fit_fn, fit_kwargs,
            extra={"chunk_rows": chunk0, "min_chunk_rows": min_chunk_rows,
                   "resilient": resilient, "policy": policy,
                   "ladder": "default" if ladder is None else repr(ladder)})
        fp = (src.fingerprint() if src is not None
              else yb.fingerprint() if distributed
              else journal_mod.panel_fingerprint(yb))
        if delta_plan is not None and not delta_plan.grown \
                and delta_plan.prior_config_hash != cfg:
            # clean adoption rests on determinism: identical rows under an
            # IDENTICAL config reproduce identical bytes
            raise delta_mod.StalePriorError(
                f"prior journal {delta_plan.prior_dir} was fitted under a "
                f"different configuration (config_hash "
                f"{delta_plan.prior_config_hash} != {cfg}); its chunks "
                "cannot be adopted into this walk — refit from scratch or "
                "point delta_from at the matching journal")
        # per-chunk content fingerprints: a LATER delta walk adopts
        # unchanged chunks by them.  A distributed panel's rows are not
        # all readable here; its entries omit the field
        chunk_fp = (None if distributed
                    else delta_mod.chunk_fp_fn(src, yb, data_cols))
        if not sharded:
            journals = [journal_mod.ChunkJournal(
                checkpoint_dir,
                config_hash=cfg,
                panel_fingerprint=fp,
                n_rows=b,
                chunk_rows=chunk0,
                resume=resume,
                process_index=process_index,
                extra=journal_extra,
                commit_hook=_journal_commit_hook,
                chunk_fp=chunk_fp,
            )]
        else:
            # one journal namespace per shard (shard_00000/…): lanes are
            # concurrent writers, and the journal's single-writer rule is
            # per namespace.  The shard layout rides in `extra` so a
            # resume under a DIFFERENT mesh is rejected as stale
            journals = []
            try:
                # lanes never open the root manifest, so a foreign job's
                # durable state in this dir would survive unnoticed until
                # the merge destroyed it — reject it BEFORE any compute
                journal_mod.check_root_manifest(
                    checkpoint_dir, config_hash=cfg,
                    panel_fingerprint=fp, n_rows=b)
                for (sid, slo, shi, _dev, _vals) in lanes:
                    extra = dict(journal_extra or {})
                    extra.update({"shard_id": sid, "shard_lo": slo,
                                  "shard_hi": shi, "n_shards": len(spans)})
                    journals.append(journal_mod.ChunkJournal(
                        checkpoint_dir,
                        config_hash=cfg,
                        panel_fingerprint=fp,
                        n_rows=b,
                        chunk_rows=chunk0,
                        resume=resume,
                        process_index=process_index,
                        shard_index=sid,
                        extra=extra,
                        commit_hook=_journal_commit_hook,
                        chunk_fp=chunk_fp,
                    ))
            except BaseException:
                # stale/torn LOCAL journal state is asymmetric across
                # processes: peers will block in the pre-merge barrier —
                # join it so the error surfaces everywhere
                _distributed_barrier()
                raise
        if delta_plan is not None and delta_plan.adopted:
            # splice the clean chunks' committed results into the NEW
            # namespace(s) BEFORE the walk starts: the resume machinery
            # then skips them like any committed chunk, and a resumed
            # delta walk never re-adopts — nor recomputes — them
            _delta_adopt(delta_plan, journals,
                         spans if sharded else None, sharded)
    deadline = watchdog_mod.Deadline(job_budget_s)

    # per-chunk telemetry rows; None (not empty) when disabled so the
    # disabled path allocates nothing and meta stays byte-identical to the
    # uninstrumented driver
    tele = obs.enabled()
    # counter baseline at fit start: THIS fit's summary reports its own
    # activity — counters are emitted as deltas from here
    counters0 = (obs.snapshot() or {}).get("counters") if tele else None
    # identity of this fit config for the first-dispatch tag
    fit_key = journal_mod.config_hash(
        fit_fn, fit_kwargs,
        extra={"resilient": resilient, "policy": policy,
               "ladder": "default" if ladder is None else repr(ladder),
               "time": t_len, "dtype": str(panel_dtype)},
    ) if tele else None

    # -- the plan, then its lanes -------------------------------------------
    lane_specs = tuple(LaneSpec(sid, slo, shi, dev)
                       for (sid, slo, shi, dev, _vals) in lanes)
    # elastic supervision applies to SINGLE-PROCESS multi-lane walks: under
    # a process group a process cannot re-stage another process's rows,
    # so multi-process jobs keep the static fail-fast layout
    elastic = sharded and len(lane_specs) > 1 and meshlib.process_count() <= 1
    plan = ExecutionPlan(
        n_rows=b,
        chunk_rows=chunk0,
        min_chunk_rows=min_chunk_rows,
        max_backoffs=max_backoffs,
        resilient=resilient,
        policy=policy,
        ladder=ladder,
        checkpoint_dir=checkpoint_dir,
        resume=resume,
        chunk_budget_s=chunk_budget_s,
        job_budget_s=job_budget_s,
        pipeline=pipeline,
        pipeline_depth=pipeline_depth,
        prefetch_depth=prefetch_depth,
        align_mode=plan_mode,
        lanes=lane_specs,
        process_index=int(process_index or 0),
        n_shards=len(spans) if sharded else 1,
        grid=grid,
        elastic=elastic,
        lane_retries=int(lane_retries),
        lane_retry_backoff_s=float(lane_retry_backoff_s),
        rebalance_threshold=float(rebalance_threshold),
    )
    # journal handles: an elastic lane READS committed state across every
    # shard namespace (adopting a quarantined/stolen-from lane's durable
    # chunks) and WRITES only its own; static walks keep the direct handle
    lane_journals = None
    if journals is not None:
        lane_journals = (
            [journal_mod.ShardJournalView(j, journals) for j in journals]
            if elastic else list(journals))
    # overlap the root-manifest merge with the last lanes' tails: while
    # slower lanes finish, shard/process 0 already reads the shard
    # manifests the committed lanes have written (read-only; the root
    # manifest's single writer is still merge_job_manifest)
    warmer = None
    if (journals is not None and sharded and len(lane_specs) > 1
            and int(process_index or 0) == 0):
        warmer = journal_mod.MergeWarmer(checkpoint_dir, len(spans))
    elastic_meta = None
    try:
        if not sharded:
            # the walk runs on the caller's stream: the committer and the
            # watchdog worker enter it on their own threads, so their
            # reads and launches are ordered after the caller's kernels
            walk_dev = torch.device(device) if src is not None else yb.device
            walk_stream = (torch.cuda.current_stream(walk_dev)
                           if walk_dev.type == "cuda" else None)
            with watchdog_mod._on_stream(walk_stream):
                results = [LaneRunner(
                    plan, lane_specs[0], fit_fn, fit_kwargs, lanes[0][4],
                    journal=(lane_journals[0] if lane_journals is not None
                             else None),
                    deadline=deadline, tele=tele, fit_key=fit_key,
                    sink=sink).run()]
        elif elastic:
            # lanes pull spans from the shared work queue, failures
            # quarantine instead of failing the job, idle lanes steal from
            # stragglers, and reassigned spans are re-staged to the
            # computing lane's device
            def _restage(rlo, rhi, dev):
                if src is not None:
                    return source_mod.SourceLane(src, base=rlo, device=dev)
                return plan_mod.RestagedPanel(yb, device=dev, base=rlo)

            supervisor = plan_mod.LaneSupervisor(
                plan, fit_fn, fit_kwargs,
                [(spec, vals) for spec, (_s, _l, _h, _d, vals)
                 in zip(lane_specs, lanes)],
                journals=lane_journals, deadline=deadline, tele=tele,
                fit_key=fit_key, restage=_restage)
            results, elastic_meta = supervisor.run()
        else:
            results = _run_static_lanes([
                functools.partial(
                    LaneRunner, plan, spec, fit_fn, fit_kwargs, vals,
                    journal=(lane_journals[i]
                             if lane_journals is not None else None),
                    deadline=deadline, tele=tele, fit_key=fit_key)
                for i, (spec, (_sid, _lo, _hi, _dev, vals))
                in enumerate(zip(lane_specs, lanes))], lane_specs)
    except BaseException:
        if warmer is not None:
            warmer.stop()
        # peer processes of a journaled sharded job are (or will be)
        # blocked in the pre-merge barrier: a process whose lane failed
        # must still JOIN it so the error surfaces everywhere instead of
        # hanging the survivors (a no-op single-process)
        if journals is not None and sharded:
            _distributed_barrier()
        raise

    # -- assemble ------------------------------------------------------------
    # results arrive one per WALKED SPAN (an elastic lane can walk several);
    # spans are disjoint and each result's pieces ascend, so the sort by
    # lo yields globally ascending pieces either way
    pieces = [p for r in results for p in r.pieces]
    pieces.sort(key=lambda p: p[0])
    oom_events, timeout_events = [], []
    for r in results:
        tag = {"shard": r.spec.shard_id} if sharded else {}
        oom_events.extend({**ev, **tag} for ev in r.oom_events)
        timeout_events.extend({**ev, **tag} for ev in r.timeout_events)
    chunk_final = min((r.chunk_final for r in results), default=chunk0)
    tele_chunks = None
    if tele:
        tele_chunks = [row for r in results for row in (r.tele_chunks or [])]
        tele_chunks.sort(key=lambda c: c["lo"])

    dtype = panel_dtype
    sink_acct = None
    if sink is not None:
        # every computed/resumed chunk already streamed out through the
        # sink — only TIMEOUT spans are materialized here (as the
        # NaN/TIMEOUT rows the in-RAM assembly would synthesize), then the
        # sink verifies its spans tile [0, n_rows) and writes the durable
        # sink manifest.  The result arrays stay None: the caller reads
        # the output shards back (NpzShardSource over the sink directory).
        sink.barrier()  # every queued write durable; param width known
        k = sink.param_width or 1
        for plo, phi, p in pieces:
            if isinstance(p, _TimeoutChunk):
                n = phi - plo
                sink.write(plo, phi, {
                    "params": np.full((n, k), np.nan, dtype),
                    "nll": np.full(n, np.nan, dtype),
                    "converged": np.zeros(n, bool),
                    "iters": np.zeros(n, np.int32),
                    "status": np.full(n, FitStatus.TIMEOUT, STATUS_DTYPE),
                })
        sink_acct = sink.finalize(b)
        params = nll = conv = iters = status = None
        counts = {m.name: int(sink_acct["status_counts"].get(
            str(m.value), 0)) for m in FitStatus}
    else:
        # parameter width for synthesized TIMEOUT rows comes from any
        # finished chunk; an all-TIMEOUT job degenerates to one NaN column
        k = next((int(p.params.shape[-1]) for _, _, p in pieces
                  if not isinstance(p, _TimeoutChunk)), 1)

        def _mat(p):
            if isinstance(p, _TimeoutChunk):
                n = p.hi - p.lo
                return (np.full((n, k), np.nan, dtype),
                        np.full(n, np.nan, dtype),
                        np.zeros(n, bool),
                        np.zeros(n, np.int32),
                        np.full(n, FitStatus.TIMEOUT, STATUS_DTYPE))
            return (_host(p.params), _host(p.neg_log_likelihood),
                    _host(p.converged), _host(p.iters), _piece_status(p))

        mats = [_mat(p) for _, _, p in pieces]
        if mats:
            params = np.concatenate([m[0] for m in mats])
            nll = np.concatenate([m[1] for m in mats])
            conv = np.concatenate([m[2] for m in mats])
            iters = np.concatenate([m[3] for m in mats])
            status = np.concatenate([m[4] for m in mats])
        else:
            # a zero-row panel, or a process of a group whose cells own no
            # lane: its LOCAL result is legitimately empty
            params = np.zeros((0, k), dtype)
            nll = np.zeros(0, dtype)
            conv = np.zeros(0, bool)
            iters = np.zeros(0, np.int32)
            status = np.zeros(0, STATUS_DTYPE)
        counts = status_counts(status)

    meta = {
        "chunk_rows_initial": chunk0,
        "chunk_rows_final": chunk_final,
        "chunks_run": len(pieces),
        "oom_backoffs": len(oom_events),
        "oom_events": oom_events,
        "timeouts": len(timeout_events),
        "timeout_events": timeout_events,
        "degraded": bool(oom_events or timeout_events),
        "status_counts": counts,
    }
    if sink_acct is not None:
        meta["sink"] = sink_acct
    if sharded:
        meta["shards"] = {
            "n_shards": len(spans),
            "spans": [[int(slo), int(shi)] for slo, shi in spans],
            "lanes_run": len({r.spec.shard_id for r in results}),
            "devices": [str(spec.device) for spec in lane_specs],
        }
        if elastic_meta is not None:
            meta["shards"]["elastic"] = elastic_meta
    if grid is not None:
        meta["grid"] = {"index": grid[0], "total": grid[1]}
        if grid_members is not None:
            meta["grid"]["fused"] = grid_members
    if delta_plan is not None:
        meta["delta"] = {"from": delta_plan.prior_dir,
                         "counts": dict(delta_plan.counts),
                         "warmstart": delta_wrapped}
    if journals is not None and not sharded:
        meta["journal"] = journals[0].accounting()
    if plan_mode is not None:
        meta["align_mode"] = plan_mode
    pipe_meta = _pipeline_meta(results, sharded)
    if src is not None:
        # host-resident accounting: the staging pool's hit/reuse counts,
        # the copy wall/bytes, and the donated-buffer high-water mark —
        # deltas against the walk's start, so a source shared across
        # walks reports per-walk numbers
        src_staging = src.stats_delta(src_stats0)
        meta["source"] = {"kind": src.kind,
                          "panel_bytes": int(src.nbytes),
                          "shape": [int(b), int(t_len)],
                          "staging_pool": src_staging}
        if pipe_meta is None:
            pipe_meta = {}  # serial source walks still report staging
        pipe_meta["staging_pool"] = src_staging
    if pipe_meta is not None:
        meta["pipeline"] = pipe_meta
    # ladder/sanitize accounting aggregated across chunks (resilient mode)
    rung_totals: dict = {}
    for _, _, p in pieces:
        for r in (getattr(p, "meta", None) or {}).get("ladder", ()):
            agg = rung_totals.setdefault(
                r["rung"], {"attempted": 0, "rescued": 0})
            agg["attempted"] += r["attempted"]
            agg["rescued"] += r["rescued"]
    if rung_totals:
        meta["ladder_totals"] = rung_totals

    telemetry = None
    if tele:
        for name, v in meta["status_counts"].items():
            if v:
                obs.counter(f"fit_status.{name}").add(v)
        extra_tele = {}
        if plan_mode is not None:
            extra_tele["align_mode"] = plan_mode
        if pipe_meta is not None and ("staging_wall_s" in pipe_meta
                                      or "staging_pool" in pipe_meta):
            # the input-staging overlap numbers ride into the manifest so
            # a budget advisor can suggest prefetch_depth next run
            extra_tele["input_staging"] = {
                k2: pipe_meta[k2] for k2 in (
                    "prefetch_depth", "chunks_staged", "staged_hits",
                    "staged_misses", "staging_wall_s", "hidden_staging_s",
                    "input_overlap_efficiency", "staging_pool")
                if k2 in pipe_meta}
        if pipe_meta is not None and "shards" in pipe_meta:
            # per-lane commit/staging overlap rides into the merged job
            # manifest so a straggler lane is a journaled fact
            extra_tele["shards_pipeline"] = pipe_meta["shards"]
        # summary() is None if the plane was disabled mid-run: drop the
        # block entirely rather than crash or journal a null
        telemetry = obs.summary(counters_since=counters0, chunks=tele_chunks,
                                **extra_tele)
        if telemetry is not None:
            meta["telemetry"] = telemetry
            if journals is not None and not sharded:
                journals[0].record_telemetry(telemetry)
            obs.emit_metrics()

    if journals is not None and sharded:
        # shard/process 0 is the single writer of the job-level manifest:
        # merge every shard namespace (chunks re-pathed shard-relative and
        # tagged with their shard id, a `shards` block, the merged
        # telemetry timeline) into ONE manifest.json after the lanes join
        _distributed_barrier()
        if int(process_index or 0) == 0:
            acct = journal_mod.merge_job_manifest(
                checkpoint_dir,
                config_hash=cfg,
                panel_fingerprint=fp,
                n_rows=b,
                chunk_rows=chunk0,
                spans=spans,
                telemetry=telemetry,
                extra=journal_extra,
                cache=warmer.stop() if warmer is not None else None,
                rebalance=elastic_meta,
            )
        else:
            # a process may own ZERO local lanes: journals is then empty,
            # but the job root is just the checkpoint dir
            acct = {"dir": os.path.abspath(checkpoint_dir),
                    "manifest": None, "merged_shards": None,
                    "config_hash": cfg,
                    "process_index": int(process_index or 0)}
        acct["chunks_resumed"] = sum(j.resumed_entries for j in journals)
        meta["journal"] = acct
    return ResilientFitResult(params, nll, conv, iters, status, meta)


def _run_static_lanes(make_runners, specs) -> list:
    """Run the lanes of a static (multi-process) sharded walk, one thread
    each, on its device inside a CUDA stream of its own — each runner is
    built on its lane's thread, so its committer reads on the lane's
    stream; re-raise the first lane's error after every lane joined (the
    others ran to completion: their journals keep their commits)."""
    parents = plan_mod._parent_streams(spec.device for spec in specs)
    results = [None] * len(specs)
    errors = [None] * len(specs)

    def _drive(i):
        try:
            with plan_mod._lane_stream(specs[i].device, parents):
                results[i] = make_runners[i]().run()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[i] = e

    if len(specs) == 1:
        _drive(0)
    else:
        threads = [threading.Thread(target=_drive, args=(i,), daemon=True,
                                    name=f"chunk-lane-{spec.shard_id}")
                   for i, spec in enumerate(specs)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    first = next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    out = [r for r in results if r is not None]
    out.sort(key=lambda r: r.spec.lo)
    return out


def _distributed_barrier() -> None:
    """Best-effort cross-process barrier before the job-manifest merge:
    process 0 must not merge shard manifests other processes are still
    writing.  A no-op (and never fatal) single-process."""
    try:
        if meshlib.process_count() <= 1:
            return
        torch.distributed.barrier()
    except Exception:  # noqa: BLE001 - the barrier is best-effort
        import warnings

        warnings.warn(
            "fit_chunked: cross-process barrier before the job-manifest "
            "merge failed; the merged manifest may briefly lag the last "
            "shard commits", stacklevel=2)


def _pipeline_meta(results, sharded: bool) -> Optional[dict]:
    """``meta["pipeline"]`` merged across lanes: a sharded plan sums the
    lanes and adds a per-shard breakdown so a slow lane is visible behind
    the aggregate."""
    pipes = [(r.spec.shard_id, r.pipe_stats, r.committer_depth)
             for r in results if r.pipe_stats is not None]
    pfs = [(r.spec.shard_id, r.pf_stats, r.prefetch_depth)
           for r in results if r.pf_stats is not None]
    if not pipes and not pfs:
        return None
    pipe_meta = {}
    commit_wall = hidden_commit = 0.0
    if pipes:
        commit_wall = sum(s.commit_wall_s for _, s, _ in pipes)
        hidden_commit = sum(s.hidden_s for _, s, _ in pipes)
        pipe_meta.update({
            "depth": pipes[0][2],
            "commits_background": sum(s.commits for _, s, _ in pipes),
            "commit_wall_s": round(commit_wall, 6),
            "driver_blocked_s": round(
                sum(s.blocked_s for _, s, _ in pipes), 6),
            "hidden_commit_s": round(hidden_commit, 6),
            "max_queue_depth": max(s.max_queue_depth for _, s, _ in pipes),
            # fraction of commit wall the driver never waited for
            "overlap_efficiency": (
                round(hidden_commit / commit_wall, 4)
                if commit_wall > 0 else None),
        })
        obs.gauge("committer.hidden_commit_s").set(round(hidden_commit, 6))
        obs.counter("committer.hidden_commit_ms").add(
            int(hidden_commit * 1000))
    staging_wall = hidden_staging = 0.0
    if pfs:
        staging_wall = sum(s.staging_wall_s for _, s, _ in pfs)
        hidden_staging = sum(s.hidden_s for _, s, _ in pfs)
        pipe_meta.update({
            "prefetch_depth": pfs[0][2],
            "chunks_staged": sum(s.staged for _, s, _ in pfs),
            "staged_hits": sum(s.hits for _, s, _ in pfs),
            "staged_misses": sum(s.misses for _, s, _ in pfs),
            "staged_invalidated": sum(s.invalidated for _, s, _ in pfs),
            "staging_wall_s": round(staging_wall, 6),
            "staging_blocked_s": round(
                sum(s.blocked_s for _, s, _ in pfs), 6),
            "hidden_staging_s": round(hidden_staging, 6),
            # fraction of input-staging wall hidden under compute
            "input_overlap_efficiency": (
                round(hidden_staging / staging_wall, 4)
                if staging_wall > 0 else None),
        })
        obs.counter("prefetch.hidden_staging_ms").add(
            int(hidden_staging * 1000))
    # end-to-end: of ALL the overlap-eligible wall (journal commits +
    # input staging), the fraction the driver never waited for
    total_wall = commit_wall + staging_wall
    total_hidden = hidden_commit + hidden_staging
    pipe_meta["end_to_end_overlap_efficiency"] = (
        round(total_hidden / total_wall, 4) if total_wall > 0 else None)
    if sharded:
        # per-shard accumulation: an ELASTIC lane walks several spans —
        # one LaneResult each — and its accounting sums into ONE row
        by_shard: dict = {}
        for sid, s, _d in pipes:
            e = by_shard.setdefault(sid, {"shard": sid})
            cw = e.get("commit_wall_s", 0.0) + s.commit_wall_s
            hc = e.get("hidden_commit_s", 0.0) + s.hidden_s
            e.update({
                "commits_background": e.get("commits_background", 0)
                + s.commits,
                "commit_wall_s": round(cw, 6),
                "hidden_commit_s": round(hc, 6),
                "overlap_efficiency": (round(hc / cw, 4) if cw > 0
                                       else None),
            })
        for sid, s, _d in pfs:
            e = by_shard.setdefault(sid, {"shard": sid})
            sw = e.get("staging_wall_s", 0.0) + s.staging_wall_s
            hs = e.get("hidden_staging_s", 0.0) + s.hidden_s
            e.update({
                "chunks_staged": e.get("chunks_staged", 0) + s.staged,
                "staging_wall_s": round(sw, 6),
                "hidden_staging_s": round(hs, 6),
                "input_overlap_efficiency": (round(hs / sw, 4) if sw > 0
                                             else None),
            })
        pipe_meta["shards"] = [by_shard[sid] for sid in sorted(by_shard)]
    return pipe_meta


def _delta_adopt(plan, journals, spans, sharded: bool) -> None:
    """Commit a delta plan's clean chunks into the new walk's journal(s).

    Adoption is an ordinary batch commit of the prior shards' bytes (zero
    compute, entry tagged ``delta.class == "adopted"`` with the source
    manifest), routed into the shard namespace whose span holds the chunk
    under a sharded plan.  Already-committed chunks (a resumed delta walk)
    are left exactly as they are: adopted chunks are never recomputed OR
    re-spliced on resume.
    """
    src_manifest = os.path.join(plan.prior_dir, "manifest.json")
    batches: dict = {}  # journal id -> (journal, [(lo, hi, path, info)])
    for entry, shard_path in plan.adopted:
        lo, hi = int(entry["lo"]), int(entry["hi"])
        if sharded:
            sid = next((i for i, (slo, shi) in enumerate(spans)
                        if slo <= lo < shi), 0)
            j = journals[sid]
        else:
            j = journals[0]
        if j.committed(lo) is not None:
            continue
        counts = entry.get("status_counts")
        if counts is None:
            with np.load(shard_path, allow_pickle=False) as z:
                counts = status_counts(np.asarray(z["status"]))
        info = {"wall_s": 0.0, "status_counts": counts,
                "delta": {"class": "adopted",
                          "source_manifest": src_manifest}}
        if entry.get("chunk_fingerprint"):
            # the planner just PROVED the new panel's rows hash to this —
            # recording the prior value verbatim skips a redundant sample
            info["chunk_fingerprint"] = entry["chunk_fingerprint"]
        batches.setdefault(id(j), (j, []))[1].append(
            (lo, hi, shard_path, info))
    for j, items in batches.values():
        adopted = j.adopt_chunks(items)
        obs.counter("delta.chunks_adopted").add(len(adopted))

"""The budget advisor's knob inference, kept inside the package for the
server's online autotuning.

``FitServer(autotune=True)`` reads each finished batch's journal manifest
and asks :func:`advise` which ``chunk_rows`` / ``pipeline_depth`` /
``prefetch_depth`` the NEXT batch should run with.  This is a copy of the
``advise`` function of the repository's ``tools/advise_budget.py`` (and of
the ``load_manifest`` helper of ``tools/inspect_journal.py``): the package
never loads anything under ``tools/``, whose command-line advisor belongs
to the reference package's side.  Only comments and the device budget
probe (which asks the CUDA driver) differ.  ``tests/test_torch_advise.py``
holds the copy against the tool on the same manifests.
"""

from __future__ import annotations

import json
import math
import os

from ..reliability.journal import TornManifestError


def load_manifest(path: str):
    """The journal manifest at ``path`` (a directory or the file itself);
    None when absent, :class:`~..reliability.journal.TornManifestError`
    when it does not parse."""
    if os.path.isdir(path):
        path = os.path.join(path, "manifest.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TornManifestError(f"{path} does not parse ({e})") from e


def _device_budget_bytes():
    """The card's memory budget when one is visible; None on a host
    without one (the advice then leans on what the recorded run proved
    instead of a budget guess)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        return int(torch.cuda.mem_get_info()[1])
    except Exception:  # noqa: BLE001 - advisory only, never fail on probe
        return None


def _percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return None
    i = min(len(xs) - 1, max(0, int(round(q * (len(xs) - 1)))))
    return xs[i]


def advise(m: dict) -> dict:
    chunks = sorted(m.get("chunks", []), key=lambda e: e["lo"])
    committed = [e for e in chunks if e["status"] == "committed"]
    timeouts = [e for e in chunks if e["status"] == "TIMEOUT"]
    if not committed:
        return {"error": "no committed chunks to learn from",
                "config_hash": m.get("config_hash")}

    # adopted delta chunks carry a synthetic wall_s of 0.0 —
    # they were spliced, not computed — and must not teach the timing
    # model that chunks are free (a 90%-adopted manifest would otherwise
    # suggest budgets that TIMEOUT the next full refit's compile chunk)
    computed = [e for e in committed
                if (e.get("delta") or {}).get("class") != "adopted"]
    walls = [e["wall_s"] for e in computed if e.get("wall_s") is not None]
    sizes = [e["hi"] - e["lo"] for e in committed]
    after = [e.get("chunk_rows_after") for e in computed
             if e.get("chunk_rows_after")]
    requested = int(m.get("chunk_rows") or max(sizes))

    # -- chunk_rows: the size the run proved it can hold ---------------------
    sustained = min(after) if after else max(sizes)
    oom_shrunk = sustained < requested
    chunk_rows = sustained

    # -- compile vs execute split (telemetry block when present) -------------
    tele = m.get("telemetry") or {}
    exec_walls, compile_walls = [], []
    for c in tele.get("chunks") or []:
        w = c.get("wall_s")
        if w is None:
            continue
        (compile_walls if c.get("phase") == "compile+execute"
         else exec_walls).append(w)
    # fall back to manifest wall_s when the run had no telemetry: treat the
    # first chunk as the compile chunk (that is where JAX pays trace+compile)
    if not exec_walls and walls:
        compile_walls = walls[:1]
        exec_walls = walls[1:] or walls[:1]

    # -- chunk_budget_s: 2x the slowest honest chunk (compile included) ------
    chunk_budget_s = None
    if walls or compile_walls:
        slowest = max(walls + compile_walls)
        chunk_budget_s = math.ceil(2.0 * slowest)
        # a run that actually timed out at a tighter budget than the new
        # suggestion is evidence the old budget was too tight, not that the
        # chunks hang — note it rather than silently raising the bound
    job_budget_s = None
    if walls:
        n_chunks_next = max(1, -(-int(m.get("n_rows", sum(sizes)))
                                 // max(1, chunk_rows)))
        per_chunk = _percentile(exec_walls, 0.9) or max(walls)
        cold = max(compile_walls) if compile_walls else per_chunk
        job_budget_s = math.ceil(1.5 * (cold + per_chunk * n_chunks_next))

    # -- pipeline_depth: hide commit latency under execute wall --------------
    commit = ((tele.get("histograms") or {}).get("journal.commit_s") or {})
    pipeline_depth = 2  # the driver default: one commit hides under one fit
    commit_mean = commit.get("mean")
    exec_mean = (sum(exec_walls) / len(exec_walls)) if exec_walls else None
    if commit_mean and exec_mean and exec_mean > 0:
        pipeline_depth = max(1, min(8, math.ceil(commit_mean / exec_mean) + 1))

    # -- prefetch_depth: hide input staging under execute wall ---------------
    # the manifest's telemetry block records the walk's input-staging
    # accounting (reliability.prefetcher) and the static align-mode plan;
    # a run without them (prefetch disabled, an older journal) keeps the
    # driver default and suggests no hint
    staging = tele.get("input_staging") or {}
    align_mode = tele.get("align_mode")
    prefetch_depth = 1  # the driver default: the classic double buffer
    staged = staging.get("chunks_staged") or 0
    staging_mean = ((staging.get("staging_wall_s") or 0.0) / staged
                    if staged else None)
    if staging_mean and exec_mean and exec_mean > 0:
        prefetch_depth = max(1, min(4, math.ceil(staging_mean / exec_mean)))

    # -- host residency: should the panel live off-device? ---------
    # the manifest records what the walk read (`extra.source`: kind and
    # panel bytes) and — for host-resident walks — the staging-pool
    # accounting; the local device's allocator budget decides whether the
    # NEXT run of this panel still fits in device memory next to its workspace
    source_extra = (m.get("extra") or {}).get("source") or {}
    pool = staging.get("staging_pool") or {}
    # panel bytes: from the source block (host/npz walks) or the panel
    # geometry every journaled walk records — so the advice fires for
    # in-memory manifests, where "go host-resident next time" is actionable
    panel_bytes = (source_extra.get("panel_bytes")
                   or ((m.get("extra") or {}).get("panel") or {}).get(
                       "bytes"))
    budget_bytes = _device_budget_bytes()
    host_resident = None
    host_resident_reason = None
    if panel_bytes and budget_bytes:
        # the walk needs the panel AND chunk workspace resident; past
        # ~60% of the budget the in-memory walk is one allocation away from
        # the OOM-backoff ladder — stage from host instead
        host_resident = panel_bytes > 0.6 * budget_bytes
        host_resident_reason = (
            f"panel {panel_bytes / 1e9:.2f} GB vs device budget "
            f"{budget_bytes / 1e9:.2f} GB")
    elif source_extra.get("kind") in ("host", "npz_dir"):
        host_resident = True  # it already ran host-resident and finished
        host_resident_reason = f"ran host-resident ({source_extra['kind']})"
    pool_ops = (pool.get("pool_hits") or 0) + (pool.get("pool_misses") or 0)
    pool_obs = None
    if pool:
        pool_obs = {
            "pool_hit_rate": (round((pool.get("pool_hits") or 0) / pool_ops,
                                    4) if pool_ops else None),
            "h2d_wall_s": pool.get("h2d_wall_s"),
            "h2d_bytes": pool.get("h2d_bytes"),
            "peak_live_device_bytes": pool.get("peak_live_device_bytes"),
            "peak_host_bytes": pool.get("peak_host_bytes"),
        }

    # -- shards: lanes for the next run's mesh walk ----------------
    # a merged sharded manifest records which lanes actually carried work
    # and how their walls balanced; a single-device manifest still says how
    # many lanes the chunk grid COULD feed (the mesh clamps to its devices)
    n_rows = int(m.get("n_rows", sum(sizes)))
    shards_block = m.get("shards") or []
    shard_obs = None
    if shards_block:
        worked = [s for s in shards_block
                  if (s.get("chunks_committed") or s.get("chunks_timeout"))]
        lane_walls = {}
        for e in chunks:
            sid = e.get("shard_id")
            if sid is not None and e.get("wall_s") is not None:
                lane_walls[sid] = lane_walls.get(sid, 0.0) + e["wall_s"]
        balance = None
        if lane_walls:
            mean_w = sum(lane_walls.values()) / len(lane_walls)
            balance = (round(max(lane_walls.values()) / mean_w, 4)
                       if mean_w > 0 else None)
        shard_obs = {
            "n_shards": len(shards_block),
            "lanes_with_work": len(worked),
            "shard_wall_balance": balance,  # max lane wall / mean lane wall
            "lane_walls_s": {str(k): round(v, 4)
                             for k, v in sorted(lane_walls.items())},
        }
        shards_suggest = max(1, len(worked))
    else:
        balance = None
        # unsharded run: each chunk can become a lane (the coarsest useful
        # split); the runtime mesh clamps this to its device count
        shards_suggest = max(1, -(-n_rows // max(1, chunk_rows)))
    # per-shard chunk_rows: every lane should walk >= 2 chunks so its
    # commit/staging has a next chunk to hide under — never grow past the
    # OOM-sustained size
    rows_per_shard = -(-n_rows // shards_suggest)
    chunk_rows_sharded = max(1, min(chunk_rows, -(-rows_per_shard // 2))) \
        if shards_suggest > 1 else chunk_rows

    # -- elastic lanes: lane_retries + rebalance_threshold --------
    # the merged manifest's `rebalance` block records what the supervisor
    # actually did — quarantine causes, steals, spans reassigned — and the
    # per-lane wall imbalance says whether the threshold let a straggler
    # pace the job.  Transient-looking causes (allocator storms, deadline
    # blips) earn the lane one more retry; deterministic failures make
    # extra retries wasted wall.
    rb = m.get("rebalance") or {}
    quarantined = rb.get("quarantined") or []
    transient_markers = ("RESOURCE_EXHAUSTED", "Out of memory",
                         "DeadlineExceeded", "OOMBackoffExceeded")
    transient = [q for q in quarantined
                 if any(t in (q.get("cause") or "") for t in transient_markers)]
    lane_retries = 1  # the driver default
    if quarantined:
        lane_retries = 2 if transient else 1
    steals = rb.get("steals") or 0
    rebalance_threshold = 4.0  # the driver default
    if balance is not None:
        if balance > 2.0:
            # a straggler paced the job and stealing never (or barely)
            # engaged: hand work off sooner next run
            rebalance_threshold = 1.5 if steals else 2.0
        elif steals and balance <= 1.2:
            # stealing engaged and the walls came out level: keep it
            rebalance_threshold = 4.0
    rebalance_obs = None
    if rb or quarantined:
        rebalance_obs = {
            "steals": steals,
            "reassigned_chunks": rb.get("reassigned_chunks"),
            "lane_retries_used": rb.get("lane_retries_used"),
            "quarantine_causes": [
                {"shard_id": q.get("shard_id"),
                 "retries": q.get("retries"),
                 "cause": (q.get("cause") or "")[:120]}
                for q in quarantined],
        }

    # -- forecast walks: horizon-aware chunk sizing ---------------
    # a forecast manifest (`extra.forecast`) records the walk's horizon,
    # augmented width, and Monte-Carlo sampling config; the per-row
    # working set then scales with horizon (packed output + S simulated
    # paths), so the proven chunk size carries as a rows x working-set
    # budget — the next run at horizon h' solves rows from the same
    # budget instead of replaying the OOM ladder
    forecast_extra = (m.get("extra") or {}).get("forecast") or {}
    forecast_obs = None
    forecast_suggest = None
    if forecast_extra:
        fh = int(forecast_extra.get("horizon") or 1)
        f_nt = int(forecast_extra.get("n_time") or 0)
        f_k = int(forecast_extra.get("k") or 0)
        f_iv = bool(forecast_extra.get("intervals"))
        f_ns = int(forecast_extra.get("n_samples") or 0) if f_iv else 0
        row_floats = (f_nt + f_k + 2) + fh * (3 if f_iv else 1) + f_ns * fh
        budget_floats = sustained * row_floats  # proven per-chunk set
        forecast_obs = {
            "model": forecast_extra.get("model"),
            "horizon": fh,
            "intervals": f_iv,
            "n_samples": f_ns or None,
            "row_working_set_floats": row_floats,
        }
        forecast_suggest = {
            "horizon": fh,
            # rows for a DIFFERENT horizon h': budget // working_set(h')
            "chunk_rows_working_set_floats": budget_floats,
            "chunk_rows_at_2x_horizon": max(1, budget_floats // (
                (f_nt + f_k + 2) + 2 * fh * (3 if f_iv else 1)
                + f_ns * 2 * fh)),
        }

    # -- delta walks: what fraction of the panel actually changed ------------
    # a delta manifest (`extra.delta`) records the planner's
    # adopted/warm/dirty/new classification; the dirty fraction is THE
    # number that says whether the tick-feed pipeline is paying
    # incremental cost or silently degenerating to full refits.  A
    # non-delta manifest whose chunks carry content fingerprints is
    # delta-ELIGIBLE: the next run of a grown/revised version of this
    # panel should pass delta_from= instead of refitting everything.
    delta_block = (m.get("extra") or {}).get("delta") or {}
    delta_obs = None
    delta_from_suggest = None
    if delta_block:
        dc = delta_block.get("counts") or {}
        total = max(1, sum(dc.values()))
        delta_obs = {
            "from": delta_block.get("from"),
            "counts": dc,
            "warmstart": delta_block.get("warmstart"),
            "dirty_fraction": round(
                1.0 - (dc.get("adopted") or 0) / total, 4),
        }
    elif any(e.get("chunk_fingerprint") for e in committed):
        delta_from_suggest = (
            "chunk fingerprints present: an appended/revised rerun of "
            "this panel can pass delta_from= at this journal and adopt "
            "every unchanged chunk")

    return {
        "config_hash": m.get("config_hash"),
        "panel_fingerprint": m.get("panel_fingerprint"),
        "observed": {
            "chunks_committed": len(committed),
            "chunks_timeout": len(timeouts),
            "chunk_rows_requested": requested,
            "chunk_rows_sustained": sustained,
            "oom_backoff_engaged": oom_shrunk,
            "chunk_wall_s_max": max(walls) if walls else None,
            "chunk_wall_s_p90": _percentile(walls, 0.9) if walls else None,
            "execute_wall_s_mean": (round(exec_mean, 4)
                                    if exec_mean is not None else None),
            "compile_wall_s_max": (max(compile_walls)
                                   if compile_walls else None),
            "commit_s_mean": commit_mean,
            "commit_s_max": commit.get("max"),
            "staging_wall_s_mean": (round(staging_mean, 4)
                                    if staging_mean is not None else None),
            "input_overlap_efficiency":
                staging.get("input_overlap_efficiency"),
            "align_mode": align_mode,
            "source_kind": source_extra.get("kind"),
            "panel_bytes": panel_bytes,
            "device_budget_bytes": budget_bytes,
            "staging_pool": pool_obs,
            "shards": shard_obs,
            "rebalance": rebalance_obs,
            "forecast": forecast_obs,
            "delta": delta_obs,
        },
        "suggest": {
            "chunk_rows": chunk_rows,
            "chunk_budget_s": chunk_budget_s,
            "job_budget_s": job_budget_s,
            "pipeline_depth": pipeline_depth,
            "prefetch_depth": prefetch_depth,
            "staging_pool_buffers": prefetch_depth + 1,
            "host_resident": host_resident,
            "host_resident_reason": host_resident_reason,
            "align_mode": align_mode,
            "shards": shards_suggest,
            "chunk_rows_per_shard": chunk_rows_sharded,
            "lane_retries": lane_retries,
            "rebalance_threshold": rebalance_threshold,
            "forecast": forecast_suggest,
            "delta_from": delta_from_suggest,
        },
    }

"""Rehydrate fitted parameters from durable journals (port of
``forecasting/params.py``).

Fit-once / forecast-many (the reference library's whole point): a fit
walk's write-ahead journal already holds every committed chunk's params,
statuses, and diagnostics as npz shards named by an atomically-updated
manifest — so a LATER process can forecast without refitting, and
without re-running the chunk driver at all: :func:`load_fit_result`
assembles the journal into the same host-side ``ResilientFitResult`` the
walk returned, byte for byte for every committed row.  Rows the job
never committed (TIMEOUT marks, uncommitted chunks of a killed run) come
back NaN with status ``TIMEOUT`` — the same synthesis the driver applies
to undispatched chunks, so a forecast over a partial journal degrades to
NaN rows, never to stale or fabricated numbers.

:func:`load_auto_members` does the same for an auto-fit search root
(``auto_manifest.json`` + per-group ``grid_*`` journals), demuxing fused
group packs back into per-order results — the input the
criterion-weighted ensemble blends.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import List, Optional, Tuple

import numpy as np

from ..reliability.journal import JournalError, TornManifestError
from ..reliability.runner import ResilientFitResult
from ..reliability.status import STATUS_DTYPE, FitStatus, status_counts

__all__ = ["load_fit_result", "load_auto_members"]


def _read_manifest(path: str) -> dict:
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TornManifestError(
            f"{path} does not parse ({e}); a mid-commit crash tore the "
            "write — inspect/remove the journal explicitly.") from e


def load_fit_result(checkpoint_dir: str) -> ResilientFitResult:
    """Assemble a fit walk's journal into a ``ResilientFitResult``.

    Reads the job-level ``manifest.json`` and loads every committed
    chunk's npz shard.  Committed rows are
    byte-identical to the walk's own output; everything else is NaN +
    ``TIMEOUT``.  A torn shard is skipped (its rows degrade to TIMEOUT)
    rather than poisoning the load — mirroring the driver's
    torn-shard-means-recompute contract, except a pure reader cannot
    recompute.
    """
    root = os.path.abspath(checkpoint_dir)
    mp = os.path.join(root, "manifest.json")
    if not os.path.exists(mp):
        raise JournalError(f"no manifest.json under {root}")
    m = _read_manifest(mp)
    n_rows = int(m["n_rows"])
    loaded: List[Tuple[int, int, dict]] = []
    k = 1
    dtype = np.dtype(np.float32)
    chunks_lost = 0
    for e in m.get("chunks", []):
        if e.get("status") != "committed":
            continue
        path = os.path.join(root, e["shard"])
        try:
            with np.load(path, allow_pickle=False) as z:
                arrs = {key: np.array(z[key]) for key in
                        ("params", "nll", "converged", "iters", "status")}
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            chunks_lost += 1
            continue
        lo, hi = int(e["lo"]), int(e["hi"])
        if arrs["params"].shape[0] != hi - lo:
            chunks_lost += 1
            continue
        k = max(k, int(arrs["params"].shape[1]))
        dtype = arrs["params"].dtype
        loaded.append((lo, hi, arrs))
    loaded.sort(key=lambda x: x[0])
    params = np.full((n_rows, k), np.nan, dtype)
    nll = np.full((n_rows,), np.nan, dtype)
    conv = np.zeros((n_rows,), bool)
    iters = np.zeros((n_rows,), np.int32)
    status = np.full((n_rows,), FitStatus.TIMEOUT, STATUS_DTYPE)
    covered = 0
    for lo, hi, arrs in loaded:
        w = arrs["params"].shape[1]
        params[lo:hi, :w] = arrs["params"]
        nll[lo:hi] = arrs["nll"]
        conv[lo:hi] = arrs["converged"]
        iters[lo:hi] = arrs["iters"]
        status[lo:hi] = arrs["status"]
        covered += hi - lo
    meta = {
        "journal": {
            "dir": root,
            "loaded_from_journal": True,
            "config_hash": m.get("config_hash"),
            "panel_fingerprint": m.get("panel_fingerprint"),
            "chunks_loaded": len(loaded),
            "chunks_lost": chunks_lost,
            "rows_covered": covered,
            "rows_missing": n_rows - covered,
        },
        "status_counts": status_counts(status),
    }
    return ResilientFitResult(params, nll, conv, iters, status, meta)


def load_auto_members(auto_root: str):
    """Per-order fit results of a durable auto-fit search.

    Reads ``auto_manifest.json`` for the grid (orders, fusion groups,
    journal dirs), loads each group's journal via
    :func:`load_fit_result`, and demuxes fused packs back into per-order
    results (``models.auto._demux_fused`` — the same unpacking the live
    search ran).  Returns ``(specs, include_intercept, results, meta)``
    where ``results`` is one host-side fit result per order in grid
    order — exactly what ``auto.select_orders`` /
    ``auto.criterion_matrix`` and the ensemble consume.
    """
    from ..models import auto as _auto

    root = os.path.abspath(auto_root)
    amp = os.path.join(root, "auto_manifest.json")
    if not os.path.exists(amp):
        raise JournalError(f"no auto_manifest.json under {root}")
    am = _read_manifest(amp)
    meta = am.get("auto_fit") or {}
    order_meta = meta.get("orders") or []
    if not order_meta:
        raise JournalError(f"{amp} records no orders")
    specs = _auto.normalize_orders([
        (tuple(o["order"]) if o.get("seasonal") is None
         else tuple(o["order"]) + (tuple(o["seasonal"]),))
        for o in sorted(order_meta, key=lambda o: o["grid_index"])])
    # include_intercept is recoverable from any order's recorded param
    # count: n_params(True) == n_params(False) + 1, always distinct
    o0 = sorted(order_meta, key=lambda o: o["grid_index"])[0]
    include_intercept = (
        int(o0["k"]) == specs[0].n_params(True))
    groups = meta.get("fusion_groups") or []
    if not groups:
        raise JournalError(f"{amp} records no fusion groups")
    results: List[Optional[object]] = [None] * len(specs)
    for grp in groups:
        gdir = os.path.join(root, grp["dir"])
        members = [int(g) for g in grp["orders"]]
        res = load_fit_result(gdir)
        if len(members) == 1:
            results[members[0]] = res
        else:
            per = _auto._demux_fused(
                res, [specs[g] for g in members], include_intercept)
            for j, g in enumerate(members):
                results[g] = per[j]
    missing = [g for g, r in enumerate(results) if r is None]
    if missing:
        raise JournalError(
            f"auto manifest {amp} fusion groups do not cover orders "
            f"{missing}")
    return specs, include_intercept, results, meta

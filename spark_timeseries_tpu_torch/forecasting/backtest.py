"""Rolling-origin backtest campaigns: expanding-window refit x horizon
(port of ``forecasting/backtest.py``).

The production question a forecast answers is "how wrong will we be?" —
and the standard answer is rolling-origin evaluation: refit on
``y[:, :origin]``, forecast ``horizon`` steps, score against the held
out actuals, slide the origin forward, repeat.  At panel scale every
window is a full fit walk, so the campaign is expressed as ONE journaled
job:

- each window's refit is an ordinary ``fit_chunked`` walk journaled
  under ``<root>/window_00000/…``, WARM-STARTED from the previous
  window's journaled params (packed into augmented columns —
  ``walk.warmstart_fit`` — like the order search's warm-started basin
  refits) when the model takes ``init_params``;
- the window's forecast is recomputed deterministically from the fit
  result (same kernels, same layout — no second journal needed);
- per-row and per-horizon error metrics (MAE / RMSE / MAPE / interval
  coverage) are written as an npz metrics shard plus a durable
  ``backtest_manifest.json`` entry, both atomic, after EVERY window.

A crash anywhere — mid-chunk, mid-window, between windows — and a rerun
with the same panel/config resumes: committed windows load their metrics
shards (digest-verified), the in-flight window's fit walk replays only
its uncommitted chunks, and the completed campaign's metrics are
BITWISE-identical to an uninterrupted run.  A manifest written under a
different panel or campaign config is rejected loudly
(:class:`StaleBacktestError`), mirroring the chunk journal's contract.

``server=`` routes every window's forecast through a resident
``serving.FitServer`` (the serving half users actually call: fit once,
forecast many), micro-batched and journaled under the server's root; the
campaign's metrics are those of the local campaign.  ``shard=`` and
``mesh=`` run the chunk walk's lanes.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..models.base import to_device
from ..reliability import journal as journal_mod
from ..reliability import source as source_mod
from . import augment, kernels, walk as walk_mod
from .params import load_fit_result

__all__ = ["BacktestResult", "StaleBacktestError", "default_origins",
           "run_backtest", "BACKTEST_MANIFEST"]

BACKTEST_MANIFEST = "backtest_manifest.json"
BACKTEST_VERSION = 1

# rows of a device panel hashed (moved to the host) at a time
_DIGEST_ROWS = 65536


class StaleBacktestError(RuntimeError):
    """The backtest manifest belongs to a different panel or campaign."""


class BacktestResult(NamedTuple):
    """Campaign output: per-window records + campaign-level aggregates.

    ``windows`` is one dict per origin (metrics aggregates + artifact
    paths); ``metrics`` the campaign-level per-horizon aggregates
    (row-count-weighted across windows); ``manifest_path`` the durable
    record (None unjournaled); ``meta`` the campaign accounting.
    """

    windows: List[dict]
    metrics: dict
    manifest_path: Optional[str]
    meta: dict


def default_origins(n_time: int, horizon: int, n_windows: int,
                    min_train: Optional[int] = None) -> List[int]:
    """Evenly spaced expanding-window origins: the first leaves
    ``min_train`` (default: half the panel) observations to fit on, the
    last leaves exactly ``horizon`` actuals to score against."""
    horizon = int(horizon)
    last = int(n_time) - horizon
    lo = int(min_train) if min_train is not None else max(8, n_time // 2)
    if last < lo:
        raise ValueError(
            f"panel of {n_time} obs cannot hold a {horizon}-step "
            f"backtest with min_train={lo}")
    n_windows = int(n_windows)
    if n_windows < 1:
        raise ValueError("n_windows must be >= 1")
    if n_windows == 1 or last == lo:
        return [last]
    step = max(1, (last - lo) // (n_windows - 1))
    origins = [lo + i * step for i in range(n_windows - 1)]
    origins.append(last)
    return sorted(set(origins))


def _norm_kwargs(kwargs: Optional[dict]):
    def norm(v):
        if isinstance(v, (list, tuple)):
            return tuple(norm(x) for x in v)
        return v

    return tuple(sorted((k, norm(v)) for k, v in (kwargs or {}).items()))


def _actuals(y, origin: int, horizon: int) -> np.ndarray:
    """Held-out actuals ``y[:, origin:origin+horizon]`` on the host."""
    if isinstance(y, source_mod.ChunkSource):
        b, t = int(y.shape[0]), int(y.shape[1])
        out = np.empty((b, horizon), y.dtype)
        step = max(1, int(y.default_chunk_rows or 4096))
        buf = np.empty((step, t), y.dtype)
        for lo in range(0, b, step):
            hi = min(lo + step, b)
            y.read_rows(lo, hi, buf[: hi - lo])
            out[lo:hi] = buf[: hi - lo, origin:origin + horizon]
        return out
    return y[:, origin:origin + horizon].cpu().numpy()


def _window_panel(y, origin: int):
    """The window's training panel ``y[:, :origin]`` in the input's own
    residency (sources stay streamed via a column window)."""
    if isinstance(y, source_mod.ChunkSource):
        return augment.ColumnBlockSource([(y, 0, origin)])
    return y[:, :origin].contiguous()


def _window_metrics(point, lo, hi, actual, level) -> dict:
    """Per-horizon + per-row error metrics (float64 host reductions —
    fixed iteration order, deterministic bytes)."""
    point = np.asarray(point, np.float64)
    actual = np.asarray(actual, np.float64)
    err = point - actual
    mask = np.isfinite(point) & np.isfinite(actual)
    errz = np.where(mask, err, 0.0)
    n_h = mask.sum(axis=0)
    n_r = mask.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        mae_h = np.where(n_h > 0, np.abs(errz).sum(0) / np.maximum(n_h, 1),
                         np.nan)
        rmse_h = np.where(n_h > 0,
                          np.sqrt((errz ** 2).sum(0) / np.maximum(n_h, 1)),
                          np.nan)
        denom_ok = mask & (np.abs(actual) > 1e-8)
        ape = np.where(denom_ok, np.abs(err) / np.maximum(
            np.abs(actual), 1e-8), 0.0)
        nd = denom_ok.sum(axis=0)
        mape_h = np.where(nd > 0, ape.sum(0) / np.maximum(nd, 1), np.nan)
        mae_row = np.where(n_r > 0, np.abs(errz).sum(1)
                           / np.maximum(n_r, 1), np.nan)
        rmse_row = np.where(n_r > 0,
                            np.sqrt((errz ** 2).sum(1)
                                    / np.maximum(n_r, 1)), np.nan)
    out = {
        "n_h": n_h.astype(np.int64), "mae_h": mae_h, "rmse_h": rmse_h,
        "mape_h": mape_h, "mae_row": mae_row, "rmse_row": rmse_row,
        "n_row": n_r.astype(np.int64),
    }
    if lo is not None and hi is not None:
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        cmask = mask & np.isfinite(lo) & np.isfinite(hi)
        inside = cmask & (actual >= lo) & (actual <= hi)
        nc = cmask.sum(axis=0)
        out["coverage_h"] = np.where(
            nc > 0, inside.sum(0) / np.maximum(nc, 1), np.nan)
        out["coverage_n_h"] = nc.astype(np.int64)
        out["coverage_level"] = np.float64(level)
    return out


def _metrics_digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(f"{name}:{a.shape}:{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _panel_prefix_digest(y, t_cols: int) -> str:
    """Residency-independent content digest of ``y[:, :t_cols]``.

    Streams sources chunk-by-chunk and a tensor in row blocks, so the same
    bytes hash identically whether the panel lives in RAM, on the card, or
    in npz/parquet shards.
    This is what lets a grown campaign prove its prefix IS the prior
    campaign's panel (``delta=True`` window adoption): the prior
    manifest records the digest of its full panel, and the grown run
    recomputes the digest of its first ``t_prior`` columns.
    """
    h = hashlib.sha256()
    t_cols = int(t_cols)
    if isinstance(y, source_mod.ChunkSource):
        b, t = int(y.shape[0]), int(y.shape[1])
        h.update(f"panel:{b}:{t_cols}:{np.dtype(y.dtype)}".encode())
        step = max(1, int(y.default_chunk_rows or 4096))
        buf = np.empty((step, t), y.dtype)
        for lo in range(0, b, step):
            hi = min(lo + step, b)
            y.read_rows(lo, hi, buf[: hi - lo])
            h.update(np.ascontiguousarray(
                buf[: hi - lo, :t_cols]).tobytes())
    else:
        b = int(y.shape[0])
        dtype = np.dtype(str(y.dtype).replace("torch.", ""))
        h.update(f"panel:{b}:{t_cols}:{dtype}".encode())
        for lo in range(0, b, _DIGEST_ROWS):
            h.update(np.ascontiguousarray(
                y[lo:lo + _DIGEST_ROWS, :t_cols].cpu().numpy()).tobytes())
    return h.hexdigest()[:16]


_WINDOW_DIR_RE = re.compile(r"^window_(\d{5})$")
_METRICS_FILE_RE = re.compile(r"^metrics_(\d{5})\.npz$")


def _adopt_prior_campaign(prior: dict, *, mp: str, root: str, y,
                          n_rows: int, n_time: int, horizon: int,
                          origins: Sequence[int],
                          window_config_hash: str):
    """Adopt a grown campaign's committed windows from a prior manifest.

    A committed window is adopted verbatim (zero fit compute) when the
    new campaign would reproduce it byte-for-byte: same window identity
    (``window_config_hash`` — everything but the origin grid), same row
    count, the new panel's first ``t_prior`` columns bitwise-equal to
    the prior panel, and the window placed at the SAME (index, origin)
    so its training prefix, held-out actuals, and forecast seed are all
    unchanged.  Every prior origin satisfied ``origin + horizon <=
    t_prior``, so a matching (index, origin) is always fully scoreable
    against the unchanged prefix.

    Non-adopted indices get their prior window dirs / metrics shards
    removed: those fit journals were written under a different training
    prefix and would be rejected as stale by the chunk journal anyway.

    Returns ``(adopted_windows, delta_info)`` or raises
    :class:`StaleBacktestError` when the prior campaign is ineligible.
    """

    def _reject(why: str):
        raise StaleBacktestError(
            f"{mp} cannot seed a delta campaign: {why}. Use a fresh "
            "directory or remove the stale manifest explicitly.")

    if prior.get("window_config_hash") != window_config_hash:
        _reject("window_config_hash mismatch — the per-window config "
                "(model/knobs/horizon/chunk grid) changed, so no prior "
                "window is reproducible")
    if int(prior.get("n_rows", -1)) != n_rows:
        _reject(f"row count changed ({prior.get('n_rows')} != {n_rows})")
    t_prior = int(prior.get("n_time", -1))
    if not 0 < t_prior <= n_time:
        _reject(f"prior n_time {t_prior} is not a prefix of {n_time}")
    prior_digest = prior.get("panel_digest")
    if prior_digest is None:
        _reject("prior manifest has no panel_digest (written before "
                "delta-eligible campaigns)")
    got = _panel_prefix_digest(y, t_prior)
    if got != prior_digest:
        _reject(f"the new panel's first {t_prior} columns differ from "
                f"the prior panel (digest {got} != {prior_digest}) — "
                "history was revised, not appended")

    adopted: List[dict] = []
    keep = set()
    for w in prior.get("windows", []):
        i, origin = int(w.get("index", -1)), int(w.get("origin", -1))
        if (w.get("status") == "committed" and 0 <= i < len(origins)
                and int(origins[i]) == origin
                and origin + horizon <= t_prior):
            entry = dict(w)
            entry["window_class"] = "adopted"
            adopted.append(entry)
            keep.add(i)
    adopted.sort(key=lambda w: int(w["index"]))
    # sweep artifacts of non-adopted indices: their journals belong to
    # the superseded origin grid and would be rejected as stale
    for name in sorted(os.listdir(root)):
        m = _WINDOW_DIR_RE.match(name) or _METRICS_FILE_RE.match(name)
        if m is None or int(m.group(1)) in keep:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        else:
            try:
                os.unlink(path)
            except OSError:
                pass
    delta_info = {
        "prior_campaign_hash": prior.get("campaign_hash"),
        "prior_n_time": t_prior,
        "adopted": len(adopted),
        "recomputed": len(origins) - len(adopted),
    }
    obs.event("backtest.delta_adopted", adopted=len(adopted),
              recomputed=len(origins) - len(adopted), prior_n_time=t_prior)
    return adopted, delta_info


def _write_metrics_npz(path: str, arrays: dict) -> None:
    """Atomic npz write of one window's metrics shard (tmp -> fsync ->
    replace, the journal's own durability primitive)."""
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".tmp-", suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _write_backtest_manifest(root: str, manifest: dict) -> None:
    """Atomic rewrite of the campaign manifest — the single writer is
    the campaign driver, after each window commits."""
    manifest["updated_at"] = time.time()
    journal_mod._atomic_write_bytes(
        os.path.join(root, BACKTEST_MANIFEST),
        (json.dumps(manifest, indent=1, sort_keys=True) + "\n").encode())


def _round_list(a, nd: int = 6) -> list:
    return [None if not np.isfinite(v) else round(float(v), nd)
            for v in np.asarray(a, np.float64)]


def run_backtest(
    y,
    model: str,
    horizon: int,
    *,
    origins: Optional[Sequence[int]] = None,
    n_windows: int = 4,
    min_train: Optional[int] = None,
    model_kwargs: Optional[dict] = None,
    fit_kwargs: Optional[dict] = None,
    warm_start: bool = True,
    intervals: bool = False,
    level: float = 0.9,
    n_samples: int = 256,
    seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: str = "auto",
    delta: bool = False,
    chunk_rows: Optional[int] = None,
    pipeline: bool = True,
    pipeline_depth: int = 2,
    prefetch_depth: int = 1,
    shard: bool = False,
    mesh=None,
    chunk_budget_s: Optional[float] = None,
    job_budget_s: Optional[float] = None,
    server=None,
    _journal_commit_hook=None,
    device="cuda",
) -> BacktestResult:
    """Run a rolling-origin backtest campaign over ``y [B, T]``.

    ``model`` is a forecast-capable model name (``forecasting.kernels``);
    ``model_kwargs`` its structural config (e.g. ``order=(1, 1, 1)``),
    ``fit_kwargs`` extra per-window fit knobs (``max_iters``, ``tol``,
    ...).  Windows are ``origins`` (explicit time positions) or
    :func:`default_origins`.  Every window's refit rides the durable
    chunk driver under ``checkpoint_dir/window_%05d``; warm starts pack
    the previous window's journaled params into augmented columns
    (models without ``init_params`` refit cold — recorded per window).
    The campaign's own durable state is ``backtest_manifest.json`` plus
    one metrics npz per window, each committed atomically after the
    window scores — a SIGKILLed campaign resumes to bitwise-identical
    metrics.  ``job_budget_s`` bounds the WHOLE campaign (remaining
    windows are skipped with status ``"timeout"``; a resume retries
    them).  ``y`` is a tensor (used where it lives), a host array (moved
    to ``device``, default ``"cuda"``) or a ``ChunkSource``.  ``server=``
    (a ``serving.FitServer``) routes each window's forecast through its
    ``submit_forecast`` — the fits stay local, the forecasts ride the
    server's micro-batched, journaled path on the server's device — with
    metrics equal to the local campaign's.  ``shard=True`` and ``mesh=``
    run the multi-lane chunk walk.

    ``delta=True`` makes a GROWN panel adopt the prior campaign in the
    same ``checkpoint_dir``: when the new panel's first ``t_prior``
    columns are bitwise the prior panel (``panel_digest``) and the
    per-window config matches (``window_config_hash``), every committed
    window that lands at the same (index, origin) is adopted verbatim —
    zero fit compute — and only windows whose origins moved or whose
    actuals extend into the appended ticks are refit (warm-started as
    usual).  The completed campaign is bitwise-identical to a fresh
    run on the grown panel; per-class window counts and walls are
    reported in ``meta["window_classes"]``.  ``delta`` changes WHICH
    work is redone, never the bytes, so it is excluded from the
    campaign identity.
    """
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    mk = kernels.normalize_model_kwargs(model, model_kwargs or {})
    cfg = dict(mk)
    k = kernels.param_width(model, cfg)
    if isinstance(y, source_mod.ChunkSource):
        b, t = int(y.shape[0]), int(y.shape[1])
    else:
        if not isinstance(y, torch.Tensor):
            y = to_device(y, device)
        device = y.device
        if y.ndim != 2:
            raise ValueError(f"expected [batch, time], got {tuple(y.shape)}")
        b, t = int(y.shape[0]), int(y.shape[1])
    # every window's fit runs on the panel's device: the device rides the
    # fit knobs (and so the campaign identity)
    fkw = _norm_kwargs({**(fit_kwargs or {}), "device": str(device)})
    origins = (sorted(int(o) for o in origins) if origins is not None
               else default_origins(t, horizon, n_windows, min_train))
    if origins[0] < 3 or origins[-1] + horizon > t:
        raise ValueError(
            f"origins {origins} do not fit a {horizon}-step horizon in "
            f"{t} observations")

    fit_fn_cold = _model_fit_fn(model, cfg, dict(fkw))
    warm_capable = warm_start and _supports_init(model)
    campaign_hash = journal_mod.config_hash(
        fit_fn_cold, {"fit_kwargs": fkw},
        extra={"backtest_version": BACKTEST_VERSION, "model": model,
               "model_kwargs": repr(mk), "horizon": horizon,
               "origins": tuple(origins), "warm_start": bool(warm_capable),
               "intervals": bool(intervals),
               "level": float(level) if intervals else None,
               "n_samples": int(n_samples) if intervals else None,
               "seed": seed, "chunk_rows": chunk_rows})
    # window-level identity: everything that pins ONE window's bytes
    # except the origin grid — two campaigns sharing it produce
    # bitwise-identical windows wherever their (index, origin) pairs
    # coincide, which is exactly what ``delta=True`` adoption relies on
    window_config_hash = journal_mod.config_hash(
        fit_fn_cold, {"fit_kwargs": fkw},
        extra={"backtest_version": BACKTEST_VERSION, "model": model,
               "model_kwargs": repr(mk), "horizon": horizon,
               "warm_start": bool(warm_capable),
               "intervals": bool(intervals),
               "level": float(level) if intervals else None,
               "n_samples": int(n_samples) if intervals else None,
               "seed": seed, "chunk_rows": chunk_rows})
    fp = (y.fingerprint() if isinstance(y, source_mod.ChunkSource)
          else journal_mod.panel_fingerprint(y))

    root = None
    manifest = None
    delta_info = None
    if checkpoint_dir is not None:
        root = os.path.abspath(checkpoint_dir)
        os.makedirs(root, exist_ok=True)
        mp = os.path.join(root, BACKTEST_MANIFEST)
        adopted_windows: List[dict] = []
        if os.path.exists(mp):
            try:
                with open(mp, "rb") as f:
                    prior = json.loads(f.read().decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise StaleBacktestError(
                    f"{mp} does not parse ({e}); a crash tore the write "
                    "— inspect/remove the campaign directory explicitly."
                ) from e
            mismatches = []
            if prior.get("campaign_hash") != campaign_hash:
                mismatches.append("campaign_hash")
            if prior.get("panel_fingerprint") != fp:
                mismatches.append("panel_fingerprint")
            if int(prior.get("n_rows", -1)) != b:
                mismatches.append("n_rows")
            if mismatches and delta:
                adopted_windows, delta_info = _adopt_prior_campaign(
                    prior, mp=mp, root=root, y=y, n_rows=b, n_time=t,
                    horizon=horizon, origins=origins,
                    window_config_hash=window_config_hash)
            elif mismatches:
                raise StaleBacktestError(
                    f"{mp} was written by a different campaign "
                    f"({', '.join(mismatches)} mismatch); resuming would "
                    "splice foreign metrics — use a fresh directory, "
                    "remove the stale one explicitly, or pass delta=True "
                    "to adopt a prior campaign's windows on a grown "
                    "panel.")
            else:
                manifest = prior
        if manifest is None:
            manifest = {
                "kind": "backtest",
                "backtest_version": BACKTEST_VERSION,
                "created_at": time.time(),
                "campaign_hash": campaign_hash,
                "window_config_hash": window_config_hash,
                "panel_fingerprint": fp,
                "panel_digest": _panel_prefix_digest(y, t),
                "n_rows": b,
                "n_time": t,
                "model": model,
                "model_kwargs": {key: (list(v) if isinstance(v, tuple)
                                       else v) for key, v in cfg.items()},
                "horizon": horizon,
                "origins": list(origins),
                "warm_start": bool(warm_capable),
                "intervals": bool(intervals),
                "level": float(level) if intervals else None,
                "n_samples": int(n_samples) if intervals else None,
                "windows": adopted_windows,
                **({"delta": delta_info} if delta_info else {}),
            }
            _write_backtest_manifest(root, manifest)

    by_index = {int(w["index"]): w
                for w in (manifest or {}).get("windows", [])}
    walk_knobs = dict(chunk_rows=chunk_rows, resume=resume,
                      pipeline=pipeline, pipeline_depth=pipeline_depth,
                      prefetch_depth=prefetch_depth, shard=shard,
                      mesh=mesh, chunk_budget_s=chunk_budget_s,
                      _journal_commit_hook=_journal_commit_hook)
    t0 = time.perf_counter()

    def _budget_left() -> Optional[float]:
        if job_budget_s is None:
            return None
        return job_budget_s - (time.perf_counter() - t0)

    windows_out: List[dict] = []
    metric_arrays: List[dict] = []
    class_counts = {"adopted": 0, "warm": 0, "cold": 0}
    class_wall_s = {"adopted": 0.0, "warm": 0.0, "cold": 0.0}
    prev_res = None  # previous window's fit result (warm-start source)
    for i, origin in enumerate(origins):
        fit_dir = (os.path.join(root, f"window_{i:05d}")
                   if root is not None else None)
        metrics_name = f"metrics_{i:05d}.npz"
        committed = by_index.get(i)
        if committed is not None and committed.get("status") == "committed":
            t_skip = time.perf_counter()
            mpath = os.path.join(root, metrics_name)
            try:
                with np.load(mpath, allow_pickle=False) as z:
                    arrays = {key: np.array(z[key]) for key in z.files}
            except (OSError, ValueError, KeyError):
                arrays = None
            if arrays is not None and \
                    _metrics_digest(arrays) == committed.get("digest"):
                cls = committed.get("window_class") or (
                    "warm" if committed.get("warm_start") else "cold")
                entry = dict(committed)
                entry["window_class"] = cls
                class_counts[cls] = class_counts.get(cls, 0) + 1
                class_wall_s[cls] = (class_wall_s.get(cls, 0.0)
                                     + time.perf_counter() - t_skip)
                metric_arrays.append(arrays)
                windows_out.append(entry)
                prev_res = None  # reload lazily only if a later window fits
                obs.event("backtest.window_skipped", window=i,
                          origin=origin, window_class=cls)
                continue
            # torn/missing metrics shard: recompute the window (the fit
            # journal makes that cheap — committed chunks replay)
        left = _budget_left()
        if left is not None and left <= 0:
            entry = {"index": i, "origin": int(origin),
                     "status": "timeout"}
            windows_out.append(entry)
            obs.event("backtest.window_timeout", window=i, origin=origin)
            continue
        with obs.span("backtest.window", window=i, origin=int(origin)):
            t_w = time.perf_counter()
            y_win = _window_panel(y, origin)
            warm = warm_capable and i > 0
            if warm and prev_res is None and root is not None:
                prev_dir = os.path.join(root, f"window_{i - 1:05d}")
                if os.path.exists(os.path.join(prev_dir, "manifest.json")):
                    prev_res = load_fit_result(prev_dir)
            warm = warm and prev_res is not None \
                and np.asarray(prev_res.params).shape == (b, k)
            from ..reliability import fit_chunked

            if warm:
                init = np.asarray(prev_res.params)[:, :k]
                st = augment.derive_status(init, prev_res.status)
                aug, nt_w, _ = augment.augmented_panel(y_win, init, st)
                fit_res = fit_chunked(
                    walk_mod.warmstart_fit, aug, resilient=False,
                    checkpoint_dir=fit_dir,
                    job_budget_s=_budget_left(),
                    journal_extra={"backtest": {
                        "window": i, "origin": int(origin),
                        "warm_start": True}},
                    model=model, n_time=nt_w, k=k,
                    model_kwargs=mk + fkw, **walk_knobs)
            else:
                fit_res = fit_chunked(
                    fit_fn_cold, y_win, resilient=False,
                    checkpoint_dir=fit_dir,
                    job_budget_s=_budget_left(),
                    journal_extra={"backtest": {
                        "window": i, "origin": int(origin),
                        "warm_start": False}},
                    **walk_knobs)
            fc = _window_forecast(
                model, cfg, fit_res, y_win, horizon,
                intervals=intervals, level=level, n_samples=n_samples,
                seed=(None if seed is None else int(seed) + i),
                server=server, device=device)
            actual = _actuals(y, origin, horizon)
            arrays = _window_metrics(fc.forecast, fc.lo, fc.hi, actual,
                                     level)
            arrays["origin"] = np.int64(origin)
            arrays["window"] = np.int64(i)
            wall = time.perf_counter() - t_w
        digest = _metrics_digest(arrays)
        cls = "warm" if warm else "cold"
        class_counts[cls] += 1
        class_wall_s[cls] += wall
        entry = {
            "index": i, "origin": int(origin), "status": "committed",
            "rows": b, "horizon": horizon,
            "warm_start": bool(warm),
            "window_class": cls,
            "fit_dir": (f"window_{i:05d}" if root is not None else None),
            "metrics_file": metrics_name if root is not None else None,
            "digest": digest,
            "wall_s": round(wall, 4),
            "fit_status_counts": fit_res.meta.get("status_counts"),
            "mae": _round_list(arrays["mae_h"]),
            "rmse": _round_list(arrays["rmse_h"]),
            "mape": _round_list(arrays["mape_h"]),
            **({"coverage": _round_list(arrays["coverage_h"])}
               if "coverage_h" in arrays else {}),
        }
        if root is not None:
            _write_metrics_npz(os.path.join(root, metrics_name), arrays)
            manifest["windows"] = [w for w in manifest["windows"]
                                   if int(w["index"]) != i]
            manifest["windows"].append(entry)
            manifest["windows"].sort(key=lambda w: int(w["index"]))
            _write_backtest_manifest(root, manifest)
        metric_arrays.append(arrays)
        windows_out.append(entry)
        prev_res = fit_res
        obs.counter("backtest.windows").inc()
        obs.event("backtest.window_committed", window=i,
                  origin=int(origin), wall_s=round(wall, 4))

    agg = _aggregate(metric_arrays, horizon, intervals)
    meta = {
        "model": model, "horizon": horizon, "origins": list(origins),
        "campaign_hash": campaign_hash, "panel_fingerprint": fp,
        "n_rows": b, "warm_start": bool(warm_capable),
        "windows_committed": sum(1 for w in windows_out
                                 if w.get("status") == "committed"),
        "windows_timeout": sum(1 for w in windows_out
                               if w.get("status") == "timeout"),
        "window_classes": {
            "counts": class_counts,
            "wall_s": {key: round(v, 4)
                       for key, v in class_wall_s.items()},
        },
        "wall_s": round(time.perf_counter() - t0, 4),
        **({"delta": delta_info} if delta_info else {}),
    }
    return BacktestResult(windows_out, agg,
                          (os.path.join(root, BACKTEST_MANIFEST)
                           if root is not None else None), meta)


def _aggregate(metric_arrays: List[dict], horizon: int,
               intervals: bool) -> dict:
    """Campaign-level per-horizon aggregates, row-count-weighted across
    windows (deterministic fixed-order float64 sums)."""
    if not metric_arrays:
        return {"windows": 0}
    n = np.zeros(horizon, np.float64)
    mae = np.zeros(horizon, np.float64)
    rmse2 = np.zeros(horizon, np.float64)
    mape = np.zeros(horizon, np.float64)
    cov = np.zeros(horizon, np.float64)
    ncov = np.zeros(horizon, np.float64)
    for a in metric_arrays:
        w = a["n_h"].astype(np.float64)
        m = np.nan_to_num(a["mae_h"], nan=0.0)
        r = np.nan_to_num(a["rmse_h"], nan=0.0)
        p = np.nan_to_num(a["mape_h"], nan=0.0)
        n += w
        mae += m * w
        rmse2 += (r ** 2) * w
        mape += p * w
        if "coverage_h" in a:
            cw = a["coverage_n_h"].astype(np.float64)
            cov += np.nan_to_num(a["coverage_h"], nan=0.0) * cw
            ncov += cw
    with np.errstate(invalid="ignore", divide="ignore"):
        out = {
            "windows": len(metric_arrays),
            "n_h": n.astype(np.int64).tolist(),
            "mae_h": _round_list(np.where(n > 0, mae / np.maximum(n, 1),
                                          np.nan)),
            "rmse_h": _round_list(np.where(
                n > 0, np.sqrt(rmse2 / np.maximum(n, 1)), np.nan)),
            "mape_h": _round_list(np.where(n > 0, mape / np.maximum(n, 1),
                                           np.nan)),
        }
        if intervals and ncov.any():
            out["coverage_h"] = _round_list(
                np.where(ncov > 0, cov / np.maximum(ncov, 1), np.nan))
    return out


def _window_forecast(model, cfg, fit_res, y_win, horizon, *, intervals,
                     level, n_samples, seed, server, device):
    """One window's forecast: the local walk on ``device``, or the
    resident ``FitServer``'s micro-batched forecast path (the window's
    rows go to the host for the server's write-ahead record)."""
    if server is None:
        return walk_mod.forecast_chunked(
            model, fit_res, y_win, horizon, model_kwargs=cfg,
            intervals=intervals, level=level, n_samples=n_samples,
            seed=seed, device=str(device))
    if isinstance(y_win, source_mod.ChunkSource):
        values = _materialize(y_win)
    elif isinstance(y_win, torch.Tensor):
        values = y_win.detach().cpu().numpy()
    else:
        values = np.asarray(y_win)
    ticket = server.submit_forecast(
        "backtest", values, fit_res, model=model, horizon=horizon,
        model_kwargs=cfg, intervals=intervals, level=level,
        n_samples=n_samples, seed=seed)
    return walk_mod.as_result(ticket.result(), horizon, intervals)


def _materialize(src) -> np.ndarray:
    out = np.empty(tuple(int(s) for s in src.shape), src.dtype)
    step = max(1, int(src.default_chunk_rows or 4096))
    for lo in range(0, out.shape[0], step):
        hi = min(lo + step, out.shape[0])
        src.read_rows(lo, hi, out[lo:hi])
    return out


def _model_fit_fn(model: str, cfg: dict, fit_kwargs: dict):
    """The cold per-window fit partial (keyword-bound so the journal's
    config hash covers the model structure and every fit knob)."""
    import functools

    from .. import models as _models

    mod = getattr(_models, model, None)
    if mod is None or not hasattr(mod, "fit"):
        raise ValueError(f"unknown model {model!r}")
    kw = dict(fit_kwargs)
    if model == "arima":
        kw["order"] = tuple(cfg["order"])
        kw["include_intercept"] = cfg["include_intercept"]
    elif model == "autoregression":
        kw["max_lag"] = cfg["max_lag"]
    elif model == "holtwinters":
        kw["period"] = cfg["period"]
        kw["model_type"] = cfg["model_type"]
    return functools.partial(mod.fit, **kw)


def _supports_init(model: str) -> bool:
    import inspect

    from .. import models as _models

    mod = getattr(_models, model, None)
    fit = getattr(mod, "fit", None)
    if fit is None:
        return False
    try:
        return "init_params" in inspect.signature(fit).parameters
    except (TypeError, ValueError):
        return False

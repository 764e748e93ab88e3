"""The chunked forecast walk: panel-scale forecasts on the fit driver
(port of ``forecasting/walk.py``).

The forecast of a panel is embarrassingly parallel — every row's future
depends only on its own history and its own fitted params — so instead of
a new execution engine, the walk reuses ``reliability.fit_chunked``
wholesale: the per-row side data (params, status, row index) is packed
into extra panel columns (:mod:`.augment`), and :func:`forecast_fit` — an
ordinary chunk "fit function" returning a ``FitResult`` whose params
matrix IS the packed ``[point | lo | hi]`` forecast block — rides the
driver.  Journaling (crash-resume replaying only uncommitted chunks),
pipelined commits, prefetch and ``ChunkSource`` streaming therefore
compose with the forecast path for free, and the composed walks are
bitwise-identical to the serial in-memory walk ON THE SAME CHUNK GRID: the
forecast functions are row-local with no cross-row coupling, staged chunks
are the same bytes in every residency, and the interval keys are
counter-based on the GLOBAL row index (``fold_in(base_key, row)``, the
threefry construction of :mod:`._prng`), never on chunk shape.

**Status propagation**: a row whose fit did not produce usable params
(status ``DIVERGED``/``EXCLUDED``/``TIMEOUT``, or non-finite params)
forecasts NaN — never garbage — and keeps its fit status in the result;
healthy rows (including ``SANITIZED``/``RETRIED``/``FALLBACK`` rescues)
forecast from their params and keep their provenance code.

**Reproducible intervals**: ``intervals=True`` adds Monte-Carlo
``level``-quantile bands from each model's forward simulation
(:mod:`.kernels`), under a base key derived deterministically from the
augmented panel's JOURNAL FINGERPRINT (or an explicit ``seed``) — the same
panel + params forecast the same bands on every run, resume and chunk
layout, bitwise.  The quantile is ``jnp.quantile``'s linear interpolation
computed from ``torch.sort`` along the paths, in row blocks, and a
gather of the two neighbouring order statistics: one chunk's paths hold
far more than the 2^24 values ``torch.quantile`` takes in a whole-tensor
reduction, and the blocks bound the sort's memory at any chunk size.
"""

from __future__ import annotations

import hashlib
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..models.base import FitResult, to_device
from ..reliability import source as source_mod
from ..reliability.journal import panel_fingerprint
from ..reliability.runner import ResilientFitResult, _host
from ..reliability.status import FitStatus, status_counts
from . import _prng, augment, kernels
from .params import load_fit_result

__all__ = ["ForecastResult", "forecast_chunked", "forecast_fit",
           "split_forecast", "warmstart_fit"]

# the bands are sorted in blocks of at most this many path values
_SORT_BLOCK = 1 << 26


class ForecastResult(NamedTuple):
    """Panel forecast output: rows align with the input panel.

    ``forecast`` is ``[B, horizon]`` point forecasts (NaN for rows whose
    fit was unusable); ``lo``/``hi`` the interval bands (None without
    ``intervals=True``); ``status`` the propagated per-row fit status;
    ``meta`` the walk accounting (``meta["forecast"]`` the forecast
    config, plus everything the chunk driver reports — journal, pipeline
    overlap, source staging).  Arrays are host numpy.
    """

    forecast: np.ndarray  # [B, horizon]
    lo: Optional[np.ndarray]  # [B, horizon] or None
    hi: Optional[np.ndarray]  # [B, horizon] or None
    status: np.ndarray  # [B] int8 FitStatus
    meta: dict


def split_forecast(pack: np.ndarray, horizon: int, intervals: bool):
    """Unpack a walk's params matrix ``[B, W]`` into (point, lo, hi).

    Tolerates the all-TIMEOUT degenerate pack (the driver synthesizes
    width-1 NaN params when no chunk ever finished)."""
    pack = _host(pack)
    b = pack.shape[0]
    want = horizon * (3 if intervals else 1)
    if pack.shape[1] != want:
        nanmat = np.full((b, horizon), np.nan, pack.dtype)
        return (nanmat, nanmat.copy() if intervals else None,
                nanmat.copy() if intervals else None)
    point = np.array(pack[:, :horizon])
    if not intervals:
        return point, None, None
    return (point, np.array(pack[:, horizon:2 * horizon]),
            np.array(pack[:, 2 * horizon:3 * horizon]))


def _quantile_sorted(srt: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q, axis=-1)`` (linear) of ``srt``, already sorted
    along its last axis: the two neighbouring order statistics of the
    position ``q (n - 1)``, weighted by its fractional part, in float64
    (as the reference interpolates under x64), cast back."""
    n = srt.shape[-1]
    pos = q * (n - 1)
    lo = min(max(math.floor(pos), 0), n - 1)
    hi = min(max(math.ceil(pos), 0), n - 1)
    hw = pos - math.floor(pos)
    out = (srt[..., lo].double() * (1.0 - hw)
           + srt[..., hi].double() * hw)
    return out.to(srt.dtype)


def _band_quantiles(paths: torch.Tensor, qs):
    """Per-(row, horizon) quantiles of ``paths [B, H, S]`` over ``S`` ->
    one ``[B, H]`` tensor per ``q`` in ``qs``.  A slice holding a NaN
    gives NaN (``jnp.quantile`` without NaN squashing).  Rows are sorted
    in blocks of at most ``_SORT_BLOCK`` values."""
    b, h, s = paths.shape
    outs = [paths.new_empty(b, h) for _ in qs]
    step = max(1, _SORT_BLOCK // max(1, h * s))
    for lo in range(0, b, step):
        blk = paths[lo:lo + step]
        srt = torch.sort(blk, dim=-1).values
        nan = torch.isnan(blk).any(-1)
        for out, q in zip(outs, qs):
            out[lo:lo + step] = torch.where(nan, torch.nan,
                                            _quantile_sorted(srt, q))
    return outs


def forecast_fit(aug, *, forecast_model, horizon, n_time, k,
                 model_kwargs=(), intervals=False, level=0.9,
                 n_samples=256, base_seed=0, device="cuda"):
    """The forecast walk's chunk fit function.

    ``aug`` is an augmented-panel chunk (``.augment`` layout; a tensor is
    forecast where it lives, anything else on ``device``).
    ``forecast_model`` names the model family — spelled distinctly from
    the serving layer's ``model`` registry-name parameter so the config
    rides a server's submit untouched.  Returns a ``FitResult`` whose
    ``params`` is the packed forecast block — which is exactly what the
    journal commits and a resume rehydrates.  Run it through
    ``fit_chunked(..., resilient=False)``: the resilient ladder must never
    "sanitize" a panel whose columns are fitted parameters.
    """
    model = str(forecast_model)
    mk = kernels.normalize_model_kwargs(model, dict(model_kwargs))
    cfg = dict(mk)
    n_time, k, horizon = int(n_time), int(k), int(horizon)
    want_k = kernels.param_width(model, cfg)
    if want_k != k:
        raise ValueError(
            f"model {model!r} with config {cfg} expects {want_k} params "
            f"per row, augmented panel carries {k}")
    if not isinstance(aug, torch.Tensor):
        aug = to_device(aug, device)
    with torch.no_grad():
        y = aug[:, :n_time]
        params = aug[:, n_time:n_time + k]
        status = aug[:, n_time + k].to(torch.int8)
        usable = (torch.isfinite(params).all(-1)
                  & (status < int(FitStatus.DIVERGED)))
        point = kernels.point_fn(model, cfg, horizon)(params, y)
        blocks = [torch.where(usable[:, None], point, torch.nan)]
        if intervals:
            rowidx = aug[:, n_time + k + 1].to(torch.int64)
            key0 = _prng.PRNGKey(int(base_seed), device=aug.device)
            keys = _prng.fold_in(key0, rowidx)
            paths = kernels.sim_fn(model, cfg, horizon, int(n_samples))(
                params, y, keys)  # [B, H, S]
            ql = (1.0 - float(level)) / 2.0
            lo, hi = _band_quantiles(paths, (ql, 1.0 - ql))
            del paths
            blocks += [torch.where(usable[:, None], lo, torch.nan),
                       torch.where(usable[:, None], hi, torch.nan)]
        pack = torch.cat(blocks, dim=1).to(aug.dtype)
        nll = torch.where(usable, 0.0, torch.nan).to(aug.dtype)
    return FitResult(pack, nll, usable,
                     torch.zeros(aug.shape[0], dtype=torch.int32,
                                 device=aug.device), status)


def warmstart_fit(aug, *, model, n_time, k, model_kwargs=(), device="cuda"):
    """Chunk fit function for a WARM-STARTED refit walk (the backtest
    campaign's expanding windows): the augmented panel carries
    ``[y (n_time) | init params (k)]`` and the model fits with
    ``init_params`` taken from the extra columns — per chunk, so the warm
    start rides any chunking or streaming, exactly like the forecast pack.
    Non-finite inits (a failed previous-window row) are zeroed, the
    model's own cold-ish default, mirroring the winners refit
    (``models.auto._refit_basin``).  Run with ``resilient=False``: the
    sanitizer must not touch param columns.  ``device`` places a
    non-tensor chunk and rides to the fit.
    """
    from ..models import arima as _arima

    cfg = dict(model_kwargs)
    if not isinstance(aug, torch.Tensor):
        aug = to_device(aug, device)
    y = aug[:, :int(n_time)]
    init = aug[:, int(n_time):int(n_time) + int(k)]
    init = torch.where(torch.isfinite(init), init, 0.0)
    if model != "arima":
        raise ValueError(
            f"warm-started refits need a fit with init_params= "
            f"(arima family); got {model!r}")
    order = tuple(cfg.pop("order"))
    cfg["device"] = aug.device  # the fit runs where its chunk lives
    return _arima.fit(y, order=order, init_params=init, **cfg)


def _derive_base_seed(fingerprint: str) -> int:
    digest = hashlib.sha256(
        ("ststpu-forecast:" + fingerprint).encode()).digest()
    return int.from_bytes(digest[:4], "big") & 0x7FFFFFFF


def forecast_chunked(
    model: str,
    fitted,
    y,
    horizon: int,
    *,
    model_kwargs: Optional[dict] = None,
    status=None,
    intervals: bool = False,
    level: float = 0.9,
    n_samples: int = 256,
    seed: Optional[int] = None,
    chunk_rows: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    resume: str = "auto",
    chunk_budget_s: Optional[float] = None,
    job_budget_s: Optional[float] = None,
    pipeline: bool = True,
    pipeline_depth: int = 2,
    prefetch_depth: int = 1,
    shard: bool = False,
    mesh=None,
    sink=None,
    _journal_commit_hook=None,
    device="cuda",
) -> ForecastResult:
    """Forecast ``horizon`` steps for every row of ``y [B, T]``.

    ``fitted`` supplies the per-row parameters: an in-memory fit result
    (anything with ``params`` [+ ``status``] — ``FitResult``,
    ``ResilientFitResult``), a raw ``[B, k]`` params array, or a STRING
    path to a fit walk's journal directory (fit once on disk, forecast
    many times later: the journal is assembled host-side via
    :func:`.params.load_fit_result`, committed rows byte identical to the
    original walk's output).  ``status`` overrides the per-row fit status
    (default: taken from ``fitted``, or derived from params finiteness)
    and gates NaN propagation.

    ``y`` is a tensor (forecast where it lives), a host array (moved to
    ``device``, default ``"cuda"``) or any ``ChunkSource`` (the augmented
    panel then STREAMS, staged to ``device``).  All the chunk driver's
    knobs ride through — ``checkpoint_dir`` journals the walk (forecast
    shards resume bitwise), pipeline/prefetch overlap staging and commits
    — and every composition is bitwise-identical to the serial in-memory
    walk.  ``shard=True`` and ``mesh=`` run the multi-lane walk of
    ``fit_chunked``, bitwise the single-lane walk.

    ``intervals=True`` adds ``level`` Monte-Carlo quantile bands
    (``n_samples`` forward simulations a row) under a base key derived
    from the augmented panel's journal fingerprint (``seed`` overrides),
    so bands are bitwise-reproducible across runs, resumes and residencies
    on the same chunk grid.
    """
    horizon = int(horizon)
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    mk = kernels.normalize_model_kwargs(model, model_kwargs or {})
    cfg = dict(mk)
    if isinstance(fitted, str):
        fitted = load_fit_result(fitted)
    if hasattr(fitted, "order_index"):
        # an auto-fit selection packs each ROW's params in its own
        # winning order's layout — reading them under one fixed order
        # would forecast finite garbage with status OK for every row
        # whose winner differs
        raise ValueError(
            "an auto-fit selection mixes parameter layouts per row "
            "(each row's winning order); forecast it with "
            "forecasting.ensemble_forecast(auto_root=..., "
            "temperature=0) — per-order walks + a per-row winner "
            "gather — not a single-order forecast")
    if hasattr(fitted, "params"):
        params = _host(fitted.params)
        if status is None:
            status = getattr(fitted, "status", None)
            status = None if status is None else _host(status)
    else:
        params = _host(fitted)
    if params.ndim != 2:
        raise ValueError(f"params must be [rows, k], got {params.shape}")
    k = kernels.param_width(model, cfg)
    if params.shape[1] < k:
        raise ValueError(
            f"model {model!r} with config {cfg} needs {k} params per "
            f"row, fitted carries {params.shape[1]}")
    params = np.ascontiguousarray(params[:, :k])
    st = augment.derive_status(params, status)
    if isinstance(y, torch.Tensor):
        device = y.device
    elif not isinstance(y, source_mod.ChunkSource):
        y = to_device(y, device)
    aug, n_time, k = augment.augmented_panel(y, params, st)

    base_seed = 0
    if intervals:
        if seed is not None:
            base_seed = int(seed)
        else:
            fp = (aug.fingerprint()
                  if isinstance(aug, source_mod.ChunkSource)
                  else panel_fingerprint(aug))
            base_seed = _derive_base_seed(fp)

    from ..reliability import fit_chunked

    journal_extra = {"forecast": {
        "model": model, "horizon": int(horizon),
        "n_time": int(n_time), "k": int(k),
        "model_kwargs": {key: (list(v) if isinstance(v, tuple) else v)
                         for key, v in cfg.items()},
        "intervals": bool(intervals),
        "level": float(level) if intervals else None,
        "n_samples": int(n_samples) if intervals else None,
        "base_seed": int(base_seed) if intervals else None,
    }}
    with obs.span("panel.forecast", model=model, horizon=int(horizon),
                  n_series=int(params.shape[0])):
        res = fit_chunked(
            forecast_fit, aug,
            chunk_rows=chunk_rows,
            resilient=False,
            checkpoint_dir=checkpoint_dir, resume=resume,
            chunk_budget_s=chunk_budget_s, job_budget_s=job_budget_s,
            pipeline=pipeline, pipeline_depth=pipeline_depth,
            prefetch_depth=prefetch_depth,
            shard=shard, mesh=mesh, sink=sink,
            journal_extra=journal_extra,
            _journal_commit_hook=_journal_commit_hook,
            # -- the forecast config (all hashed into the journal id) --
            forecast_model=model, horizon=int(horizon),
            n_time=int(n_time), k=int(k), model_kwargs=mk,
            intervals=bool(intervals), level=float(level),
            n_samples=int(n_samples), base_seed=int(base_seed),
            device=str(device),
        )
    if res.params is None:
        # write-back mode: the packed forecasts streamed out as durable
        # output shards under key "params"; read them back at O(chunk)
        # footprint with NpzShardSource(sink_dir, key="params") and
        # split_forecast.  meta["sink"] carries the accounting and
        # meta["status_counts"] the per-row outcome totals.
        meta = dict(res.meta)
        meta["forecast"] = {**journal_extra["forecast"],
                            "status_counts": res.meta["status_counts"]}
        obs.counter("forecast.walks").inc()
        return ForecastResult(None, None, None, None, meta)
    point, lo, hi = split_forecast(res.params, int(horizon),
                                   bool(intervals))
    out_status = _host(res.status).astype(np.int8)
    meta = dict(res.meta)
    meta["forecast"] = {**journal_extra["forecast"],
                        "status_counts": status_counts(out_status)}
    obs.counter("forecast.walks").inc()
    return ForecastResult(point, lo, hi, out_status, meta)


def as_result(res: ResilientFitResult, horizon: int,
              intervals: bool) -> ForecastResult:
    """Wrap a raw forecast-walk fit result into a
    :class:`ForecastResult`."""
    point, lo, hi = split_forecast(res.params, int(horizon),
                                   bool(intervals))
    return ForecastResult(point, lo, hi,
                          _host(res.status).astype(np.int8),
                          dict(getattr(res, "meta", {}) or {}))

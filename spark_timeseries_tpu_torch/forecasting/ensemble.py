"""Criterion-weighted forecast ensembles over an auto-fit order grid (port
of ``forecasting/ensemble.py``).

A hard argmin throws away everything the losing candidates learned; the
standard repair is Akaike weighting — per row, each candidate order gets
``w_g ∝ exp(-Δ_g / (2 T))`` where ``Δ_g`` is its criterion excess over
the row's best and ``T`` the temperature — and the ensemble forecast is
the weight-blended member forecast.  ``auto_fit(return_criteria=True)``
already surfaces the ``[G, B]`` criteria matrix; this module turns it
into weights (:func:`criterion_weights`), runs one chunked forecast walk
per member order (journaled under ``<root>/forecast_%05d`` — every walk
composes with the driver exactly like a single-model forecast), and
blends points and interval bands.

At ``temperature=0`` selection degenerates BITWISE to the argmin winner:
the blend is not a weighted sum with a one-hot weight (``0 * NaN`` and
``x + 0.0`` both break bit identity) but a literal per-row gather of the
winning member's forecast — ties to the earlier grid entry, the same
contract as ``auto._select_program``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..models import auto as _auto
from ..models.base import to_device
from ..reliability import source as source_mod
from ..reliability.runner import _host
from ..reliability.status import FitStatus
from . import walk as walk_mod
from .params import load_auto_members

__all__ = ["EnsembleForecast", "criterion_weights", "ensemble_forecast"]


class EnsembleForecast(NamedTuple):
    """Blended panel forecast plus the selection record.

    ``weights`` is the ``[G, B]`` member weight matrix (columns sum to 1
    where any member is eligible, all-zero where none is);
    ``order_index`` the per-row argmin winner (``-1``: none eligible);
    ``member_forecasts`` the stacked ``[G, B, H]`` member points (kept so
    callers can audit the blend).
    """

    forecast: np.ndarray  # [B, H]
    lo: Optional[np.ndarray]
    hi: Optional[np.ndarray]
    weights: np.ndarray  # [G, B]
    order_index: np.ndarray  # [B] int32
    status: np.ndarray  # [B] int8
    orders: tuple
    member_forecasts: np.ndarray  # [G, B, H]
    meta: dict


def criterion_weights(criteria, temperature: float = 1.0) -> np.ndarray:
    """Softmax Akaike-style weights from a ``[G, B]`` criteria matrix.

    ``w_g = exp(-(c_g - min_g c) / (2 * temperature))`` normalized per
    row; non-finite criteria get weight 0 (an ineligible candidate can
    never contribute), rows with no finite candidate are all-zero.
    ``temperature=0`` returns the exact one-hot argmin (ties to the
    earlier grid entry); weights are float64 regardless of panel dtype —
    they are selection metadata, not panel bytes.
    """
    c = np.asarray(criteria, np.float64)
    if c.ndim != 2:
        raise ValueError(f"criteria must be [G, B], got {c.shape}")
    temperature = float(temperature)
    if temperature < 0:
        raise ValueError("temperature must be >= 0")
    finite = np.isfinite(c)
    any_f = finite.any(axis=0)
    cz = np.where(finite, c, np.inf)
    if temperature == 0.0:
        best = np.argmin(cz, axis=0)  # first-min ties, like argmin select
        w = np.zeros(c.shape, np.float64)
        w[best[any_f], np.nonzero(any_f)[0]] = 1.0
        return w
    cmin = np.min(cz, axis=0)
    with np.errstate(invalid="ignore", over="ignore"):
        w = np.where(finite & any_f[None, :],
                     np.exp(-(cz - np.where(any_f, cmin, 0.0)[None, :])
                            / (2.0 * temperature)), 0.0)
    s = w.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.where(s[None, :] > 0, w / np.maximum(s[None, :], 1e-300),
                     0.0)
    return w


def ensemble_forecast(
    y,
    horizon: int,
    *,
    orders: Optional[Sequence] = None,
    criterion: str = "aicc",
    temperature: float = 1.0,
    include_intercept: bool = True,
    auto_root: Optional[str] = None,
    members: Optional[Sequence] = None,
    intervals: bool = False,
    level: float = 0.9,
    n_samples: int = 256,
    seed: Optional[int] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_rows: Optional[int] = None,
    fit_kwargs: Optional[dict] = None,
    device="cuda",
    **walk_kwargs,
) -> EnsembleForecast:
    """Blend per-order forecasts with softmax criterion weights.

    Member fits come from ONE of: ``auto_root`` (a durable
    ``auto_fit(checkpoint_dir=...)`` search root — fit once on disk,
    ensemble-forecast many times later; orders and intercept convention
    are read from its manifest), ``members`` (pre-fit per-order results
    in ``orders`` grid order), or — neither given — fresh per-order fit
    walks run here (journaled under ``<root>/grid_%05d`` when
    ``checkpoint_dir`` is set, ``fit_kwargs`` forwarded).  Seasonal
    candidates are rejected (seasonal forecasting is a ROADMAP
    follow-on).  Criteria are recomputed on device from the member nlls
    (``auto.criterion_matrix``), weights via :func:`criterion_weights`;
    each member order forecasts the whole panel through a chunked
    forecast walk (journaled under ``<root>/forecast_%05d``), and the
    blend renormalizes per row over members whose forecast is usable.
    ``temperature=0`` recovers the argmin winner bitwise.

    ``y`` is a tensor (used where it lives), a host array (moved to
    ``device``, default ``"cuda"``) or a ``ChunkSource`` (staged to
    ``device``).
    """
    if isinstance(y, torch.Tensor):
        device = y.device
    elif not isinstance(y, source_mod.ChunkSource):
        y = to_device(y, device)
    if auto_root is not None:
        specs, include_intercept, results, _am = load_auto_members(
            auto_root)
        if orders is not None:
            want = _auto.normalize_orders(orders)
            if want != specs:
                raise ValueError(
                    "orders= disagrees with the auto root's grid; omit "
                    "orders or pass the same grid")
    else:
        specs = _auto.normalize_orders(orders)
        results = list(members) if members is not None else None
        if results is not None and len(results) != len(specs):
            raise ValueError(
                f"{len(specs)} orders but {len(results)} member results")
    if any(s.seasonal is not None for s in specs):
        raise ValueError(
            "seasonal orders cannot be ensemble-forecast yet (seasonal "
            "forecasting is a ROADMAP follow-on)")
    g_total = len(specs)

    if auto_root is None and results is None:
        import functools

        from ..models import arima as _arima
        from ..reliability import fit_chunked

        results = []
        for g, spec in enumerate(specs):
            fit_fn = functools.partial(
                _arima.fit, order=spec.order,
                include_intercept=include_intercept,
                **dict(fit_kwargs or {}))
            ckpt = (os.path.join(checkpoint_dir, f"grid_{g:05d}")
                    if checkpoint_dir is not None else None)
            results.append(fit_chunked(
                fit_fn, y, resilient=False, chunk_rows=chunk_rows,
                checkpoint_dir=ckpt, grid=(g, g_total), device=device,
                **walk_kwargs))

    nv0 = _auto.panel_n_valid(y)
    nll_stack = np.stack([_host(r.neg_log_likelihood)
                          for r in results])
    criteria = _auto.criterion_matrix(
        specs, nll_stack, nv0, criterion=criterion,
        include_intercept=include_intercept).numpy()
    weights = criterion_weights(criteria, temperature)

    member_fc = []
    for g, spec in enumerate(specs):
        ckpt = (os.path.join(checkpoint_dir, f"forecast_{g:05d}")
                if checkpoint_dir is not None else None)
        fc = walk_mod.forecast_chunked(
            "arima", results[g], y, horizon,
            model_kwargs={"order": spec.order,
                          "include_intercept": include_intercept},
            intervals=intervals, level=level, n_samples=n_samples,
            seed=(None if seed is None else int(seed) + g),
            chunk_rows=chunk_rows, checkpoint_dir=ckpt, device=device,
            **walk_kwargs)
        member_fc.append(fc)
    points = np.stack([fc.forecast for fc in member_fc])  # [G, B, H]
    los = (np.stack([fc.lo for fc in member_fc]) if intervals else None)
    his = (np.stack([fc.hi for fc in member_fc]) if intervals else None)
    statuses = np.stack([np.asarray(fc.status, np.int8)
                         for fc in member_fc])

    b = points.shape[1]
    finite_c = np.isfinite(criteria)
    any_f = finite_c.any(axis=0)
    cz = np.where(finite_c, criteria, np.inf)
    order_index = np.where(any_f, np.argmin(cz, axis=0),
                           -1).astype(np.int32)

    if float(temperature) == 0.0:
        # literal winner gather: bitwise the argmin member's forecast
        rows = np.arange(b)
        idx = np.where(any_f, order_index, 0)
        point = np.where(any_f[:, None], points[idx, rows], np.nan)
        lo = (np.where(any_f[:, None], los[idx, rows], np.nan)
              if intervals else None)
        hi = (np.where(any_f[:, None], his[idx, rows], np.nan)
              if intervals else None)
        status = np.where(any_f, statuses[idx, rows],
                          np.int8(FitStatus.DIVERGED)).astype(np.int8)
    else:
        usable = np.isfinite(points).all(axis=2)  # [G, B]
        eff = weights * usable
        s = eff.sum(axis=0)
        with np.errstate(invalid="ignore", divide="ignore"):
            effn = np.where(s[None, :] > 0,
                            eff / np.maximum(s[None, :], 1e-300), 0.0)
        point = np.einsum("gb,gbh->bh",
                          effn, np.nan_to_num(points, nan=0.0))
        point = np.where(s > 0, point.T, np.nan).T.astype(points.dtype)
        if intervals:
            lo = np.einsum("gb,gbh->bh", effn,
                           np.nan_to_num(los, nan=0.0))
            lo = np.where(s > 0, lo.T, np.nan).T.astype(points.dtype)
            hi = np.einsum("gb,gbh->bh", effn,
                           np.nan_to_num(his, nan=0.0))
            hi = np.where(s > 0, hi.T, np.nan).T.astype(points.dtype)
        else:
            lo = hi = None
        contrib = eff > 0
        status = np.where(
            contrib.any(axis=0),
            np.min(np.where(contrib, statuses,
                            np.int8(FitStatus.TIMEOUT)), axis=0),
            np.int8(FitStatus.DIVERGED)).astype(np.int8)

    meta = {
        "ensemble": {
            "criterion": criterion,
            "temperature": float(temperature),
            "orders": [s.label for s in specs],
            "include_intercept": bool(include_intercept),
            "auto_root": auto_root,
            "horizon": int(horizon),
            "intervals": bool(intervals),
            "rows_none_eligible": int((~any_f).sum()),
        },
        "criteria_matrix": criteria,
    }
    obs.counter("forecast.ensembles").inc()
    return EnsembleForecast(point, lo, hi, weights, order_index, status,
                            specs, points, meta)

"""AR(p) by ordinary least squares (port of ``models/autoregression.py``).

A lag-matrix OLS with no iterative optimizer: one ridge-stabilized
normal-equations solve per series over the whole panel, with the Gram
matrix built from masked inner products of shifted views (no ``[B, n, p]``
design is materialized).  Parameter layout as ARIMA's: ``[c, phi_1 ..
phi_p]`` (c = 0 when ``no_intercept``).
"""

from __future__ import annotations

import math

import torch

from . import arima as _arima
from .base import (FitResult, align_right, debatch, derive_status,
                   ensure_batched, to_device)


def fit(y, max_lag: int = 1, no_intercept: bool = False, *,
        device="cuda") -> FitResult:
    """OLS fit of ``y_t`` on ``[1?, y_{t-1} .. y_{t-max_lag}]`` for one
    series ``[time]`` or a panel ``[batch, time]``.

    Leading and trailing NaNs are tolerated (right-aligned 0/1 row weights
    in the normal equations); too-short series come back NaN with
    ``converged=False``.
    """
    yb, single = ensure_batched(to_device(y, device))
    with torch.no_grad():
        out = _fit(yb, max_lag, no_intercept)
    return debatch(out, single)


def _fit(yb, max_lag: int, no_intercept: bool) -> FitResult:
    ya, nv = align_right(yb)
    b, n = ya.shape
    target = ya[:, max_lag:]  # row i regresses t = max_lag + i
    cols = [] if no_intercept else [torch.ones_like(target)]
    cols += [ya[:, max_lag - k:n - k] for k in range(1, max_lag + 1)]
    # lags reach back to t - max_lag: rows with t - max_lag < start carry
    # padding and get weight 0
    start = (n - nv)[:, None]
    w = (torch.arange(n - max_lag, device=ya.device)[None, :]
         >= start).to(ya.dtype)
    beta = _arima._wols_cols(cols, target, w)
    pred = sum(beta[:, j, None] * c for j, c in enumerate(cols))
    if no_intercept:
        beta = torch.cat([beta.new_zeros(b, 1), beta], dim=1)
    resid = (target - pred) * w
    n_eff = (nv - max_lag).to(ya.dtype)
    sigma2 = (resid * resid).sum(-1) / n_eff
    nll = 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)
    ok = nv >= max_lag + (1 if no_intercept else 2) + 1
    params = torch.where(ok[:, None], beta, torch.nan)
    return FitResult(params, torch.where(ok, nll, torch.nan), ok,
                     torch.zeros(b, dtype=torch.int32, device=ya.device),
                     derive_status(ok, ok, params))


def forecast(params, y, max_lag: int, n_future: int, *, device="cuda"):
    """Iterate the AR recursion forward (the ARIMA(p,0,0) forecast)."""
    return _arima.forecast(params, y, (max_lag, 0, 0), n_future,
                           device=device)


def sample(params, gen, n: int, max_lag: int, sigma: float = 1.0, *,
           device="cuda"):
    """Simulate ``n`` steps with N(0, sigma^2) innovations drawn from
    ``gen`` (a ``torch.Generator`` or an integer seed)."""
    return _arima.sample(params, gen, n, (max_lag, 0, 0), sigma=sigma,
                         device=device)


def remove_time_dependent_effects(params, y, max_lag: int, *,
                                  device="cuda"):
    """Series -> innovations: ``e_t = y_t - c - sum phi_i y_{t-i}``."""
    return _arima.remove_time_dependent_effects(params, y, (max_lag, 0, 0),
                                                device=device)


def add_time_dependent_effects(params, x, max_lag: int, *, device="cuda"):
    return _arima.add_time_dependent_effects(params, x, (max_lag, 0, 0),
                                             device=device)

"""Regression with AR(1) errors by Cochrane-Orcutt (port of
``models/regression_arima.py``).

``y = X beta + u`` with ``u_t = rho u_{t-1} + e_t``: OLS, then AR(1) on the
residuals, then a quasi-differenced re-estimate, for a fixed number of
rounds.  Every round is one batched normal-equations solve over the panel.
Result layout: ``params = [beta_0 .. beta_k, rho]`` with ``beta_0`` the
intercept.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..utils.linalg import ols as _ols
from .base import ALIGN_MODES, FitResult, debatch, derive_status, to_device


def _design(X):
    """Prepend an intercept column: ``[..., n, k] -> [..., n, k+1]``."""
    return torch.cat([torch.ones_like(X[..., :1]), X], dim=-1)


def fit_cochrane_orcutt(y, X, *, max_iter: int = 10,
                        device="cuda") -> FitResult:
    """Fit ``y [batch?, n]`` on the regressors ``X [batch?, n, k]`` ->
    ``params [batch?, k+2]``: intercept, k slopes, rho."""
    y = to_device(y, device)
    X = to_device(X, device, dtype=y.dtype)
    single = y.ndim == 1
    yb = y[None] if single else y
    Xb = X[None] if single else X
    with torch.no_grad():
        out = _cochrane_orcutt(yb, Xb, max_iter)
    return debatch(out, single)


def _cochrane_orcutt(yb, Xb, max_iter: int) -> FitResult:
    Xd = _design(Xb)  # [B, n, k+1]
    beta = _ols(Xd, yb)
    rho = yb.new_zeros(yb.shape[0])
    for _ in range(max_iter):
        u = yb - (Xd @ beta[..., None])[..., 0]
        # AR(1) of the residuals (no intercept)
        rho = (u[:, 1:] * u[:, :-1]).sum(-1) / torch.clamp(
            (u[:, :-1] ** 2).sum(-1), min=1e-12)
        rho = torch.clamp(rho, -0.999, 0.999)
        # quasi-differences; the intercept column becomes (1 - rho)
        ys = yb[:, 1:] - rho[:, None] * yb[:, :-1]
        Xs = Xd[:, 1:] - rho[:, None, None] * Xd[:, :-1]
        beta = _ols(Xs, ys)
    u = yb - (Xd @ beta[..., None])[..., 0]
    e = u[:, 1:] - rho[:, None] * u[:, :-1]
    n = e.shape[1]
    sigma2 = (e * e).sum(-1) / n
    nll = 0.5 * n * (torch.log(2.0 * math.pi * sigma2) + 1.0)
    params = torch.cat([beta, rho[:, None]], dim=1)
    b = yb.shape[0]
    ones = torch.ones(b, dtype=torch.bool, device=yb.device)
    return FitResult(params, nll, ones,
                     torch.full((b,), max_iter, dtype=torch.int32,
                                device=yb.device),
                     derive_status(ones, ones, params))


def fit(y, X, method: str = "cochrane-orcutt", *,
        align_mode: Optional[str] = None, **kwargs) -> FitResult:
    """``RegressionARIMA.fitModel`` dispatcher; ``kwargs`` go to
    :func:`fit_cochrane_orcutt` (``max_iter``, ``device``).

    ``align_mode`` is validated for chunk-driver uniformity only:
    Cochrane-Orcutt has no ragged-panel alignment, NaNs propagate to NaN
    params, flagged by ``status``.
    """
    if align_mode is not None and align_mode not in ALIGN_MODES:
        raise ValueError(
            f"unknown align_mode {align_mode!r} (one of {ALIGN_MODES})")
    if method not in ("cochrane-orcutt", "cochrane_orcutt"):
        raise ValueError(
            f"unknown method {method!r} (supported: cochrane-orcutt)")
    return fit_cochrane_orcutt(y, X, **kwargs)


def predict(params, X, *, device="cuda"):
    """The regression part only: ``X [batch?, n, k]`` -> fitted values
    ``[batch?, n]``."""
    X = to_device(X, device)
    pb = to_device(params, device, dtype=X.dtype)
    single = X.ndim == 2
    Xb = X[None] if single else X
    pb = pb[None, :] if pb.ndim == 1 else pb
    out = (_design(Xb) @ pb[:, :-1, None])[..., 0]
    return out[0] if single else out

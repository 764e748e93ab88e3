"""ARIMA(p, d, q): the flagship model family (port of ``models/arima.py``,
non-seasonal part).

The whole panel is one batch: align -> difference -> Hannan-Rissanen init ->
lockstep batched L-BFGS on the mean CSS negative log-likelihood ->
``FitResult`` with per-row status.  Two backends compute the CSS objective:

- ``"cuda"``: the hand-written kernels (``ops.cuda_kernels``) on the
  time-major panel the fit builds once, with the adjoint kernel as the
  gradient and the moment kernel behind the init;
- ``"eager"``: plain PyTorch (:func:`css_neg_loglik`, differentiated by
  autograd; :func:`hannan_rissanen_batched`), on any device and dtype.

Parameter vector layout: ``[c (if intercept), phi_1..phi_p,
theta_1..theta_q]``.  Seasonal orders are a later slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import cuda_kernels as ck
from ..utils import optim
from ..utils.linalg import ridge_solve as _ridge_solve
from .base import (FitResult, align_mode_on_host, debatch, debatch_fit,
                   derive_status, ensure_batched, maybe_align,
                   require_pallas_for_count_evals, resolve_align_mode,
                   resolve_backend, to_device)

Order = Tuple[int, int, int]

# module-level so tests can monkeypatch the gate; the value and the cap
# sizing live with the compaction feature (utils.optim)
_COMPACT_MIN_BATCH = optim.COMPACT_MIN_BATCH

METHODS = ("css-lbfgs", "css-cgd", "css-bobyqa", "hannan-rissanen")


def _n_params(order: Order, include_intercept: bool) -> int:
    p, _, q = order
    return int(include_intercept) + p + q


def _split_params(params, order: Order, include_intercept: bool):
    """``[..., k]`` -> ``(c, phi [..., p], theta [..., q])``."""
    p, _, q = order
    i = int(include_intercept)
    c = (params[..., 0] if include_intercept
         else params.new_zeros(params.shape[:-1]))
    return c, params[..., i:i + p], params[..., i + p:i + p + q]


def _difference(y, d: int):
    """Order-d differencing along the last axis, first d entries dropped."""
    for _ in range(d):
        y = y[..., 1:] - y[..., :-1]
    return y


def _lagged(yd, p: int):
    """``[B, n, p]`` lags 1..p of ``yd [B, n]``, zero before the start."""
    cols = [_shift_cols(yd, k) for k in range(1, p + 1)]
    if not cols:
        return yd.new_zeros(*yd.shape, 0)
    return torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# CSS likelihood (the eager backend's objective)
# ---------------------------------------------------------------------------


def _css_errors_poly(c, phi, theta, yd, condition: bool = True,
                     n_valid=None):
    """One-step-ahead prediction errors ``[B, n]`` of the ARMA recursion
    with lag-coefficient rows ``phi [B, p]`` / ``theta [B, q]``.

    ``condition=True`` zeroes the errors of the first ``p`` valid steps
    (the conditional likelihood); ``condition=False`` keeps every valid
    step.  ``n_valid [B]`` marks a right-aligned valid span: the prefix of
    ``yd`` before it is zeroed and its errors forced to 0.
    """
    b, n = yd.shape
    p, q = phi.shape[-1], theta.shape[-1]
    t_idx = torch.arange(n, device=yd.device)
    start = torch.zeros(b, dtype=torch.long, device=yd.device)
    if n_valid is not None:
        start = n - n_valid.long()
        # differencing across the padding boundary leaves a garbage value
        # at yd[start-1]; lags reaching below start must read zeros
        yd = torch.where(t_idx[None, :] >= start[:, None], yd, 0.0)
    ylags = _lagged(yd, p)  # [B, n, p]
    zero_before = start + p if condition else start
    errs = yd.new_zeros(b, q)  # newest first
    out = []
    for t in range(n):
        pred = c + (phi * ylags[:, t]).sum(-1)
        if q:
            pred = pred + (theta * errs).sum(-1)
        e = torch.where(t >= zero_before, yd[:, t] - pred, 0.0)
        if q:
            errs = torch.cat([e[:, None], errs[:, :-1]], dim=1)
        out.append(e)
    return torch.stack(out, dim=1)


def _css_errors(params, yd, order: Order, include_intercept: bool,
                condition: bool = True, n_valid=None):
    c, phi, theta = _split_params(params, order, include_intercept)
    return _css_errors_poly(c, phi, theta, yd, condition=condition,
                            n_valid=n_valid)


def css_neg_loglik(params, yd, order: Order, include_intercept: bool,
                   n_valid=None):
    """Negative CSS Gaussian log-likelihood ``[B]`` with the innovation
    variance concentrated out (sigma^2 = CSS / n_eff)."""
    p = order[0]
    nv = (torch.full((yd.shape[0],), yd.shape[1], dtype=yd.dtype,
                     device=yd.device)
          if n_valid is None else n_valid.to(yd.dtype))
    e = _css_errors(params, yd, order, include_intercept, n_valid=n_valid)
    n_eff = nv - p
    sigma2 = (e * e).sum(-1) / n_eff
    return 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)


def approx_aic(params, yd, order: Order, include_intercept: bool):
    k = _n_params(order, include_intercept)
    return 2.0 * css_neg_loglik(params, yd, order, include_intercept) + 2.0 * k


# ---------------------------------------------------------------------------
# Hannan-Rissanen initialization (the eager backend's init)
# ---------------------------------------------------------------------------


def _shift_cols(x2, k: int):
    """``[B, T]`` shifted right by ``k`` along time (zero-fill)."""
    if k == 0:
        return x2
    return torch.nn.functional.pad(x2, (k, 0))[:, :x2.shape[1]]


def _wols_cols(cols, y2, w, ridge: float = 1e-8):
    """Weighted OLS from ``[B, T]`` column vectors: the ridge-stabilized
    normal equations of ``X * w`` (binary weights) from masked inner
    products, with no ``[B, T, k]`` design materialized."""
    XtX = torch.stack(
        [torch.stack([(w * ci * cj).sum(1) for cj in cols], -1)
         for ci in cols], -2)
    Xty = torch.stack([(w * ci * y2).sum(1) for ci in cols], -1)
    return _ridge_solve(XtX, Xty, ridge)


def hannan_rissanen_batched(yd, order: Order, include_intercept: bool, nvd):
    """Two-stage startup values ``[B, k]``: a long-AR fit's residuals stand
    in for the unobserved innovations, then one OLS of y on ``[1?, y-lags,
    e-lags]``.  Rows before each series' valid span get weight 0."""
    p, _, q = order
    b, n = yd.shape
    m = min(p + q + 1, max(n // 4, 1))
    t = torch.arange(n, device=yd.device)[None, :]
    start = n - nvd.long()
    w1 = (t >= (start + m)[:, None]).to(yd.dtype)
    shifts = [_shift_cols(yd, i) for i in range(max(m, p) + 1)]
    ones = torch.ones_like(yd)

    cols1 = [ones] + shifts[1:m + 1]
    beta1 = _wols_cols(cols1, yd, w1)  # [B, m+1]
    pred = sum(beta1[:, j, None] * c for j, c in enumerate(cols1))
    ehat = (yd - pred) * w1

    cols2 = ([ones] if include_intercept else []) + shifts[1:p + 1]
    cols2 += [_shift_cols(ehat, j) for j in range(1, q + 1)]
    if not cols2:
        return yd.new_zeros(b, 0)
    w2 = (t >= (start + m + q)[:, None]).to(yd.dtype)
    return _wols_cols(cols2, yd, w2)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------


def fit(
    y,
    order: Order,
    include_intercept: bool = True,
    *,
    seasonal=None,
    method: str = "css-lbfgs",
    init_params=None,
    max_iters: int = 60,
    tol: Optional[float] = None,
    backend: str = "auto",
    count_evals: bool = False,
    compact: bool = True,
    align_mode: Optional[str] = None,
    device="cuda",
) -> FitResult:
    """Fit ARIMA(p,d,q) to one series ``[time]`` or a panel
    ``[batch, time]`` (numpy or tensor; moved to ``device``).

    ``method``: ``"css-lbfgs"`` (also ``"css-cgd"`` / ``"css-bobyqa"``, the
    reference's names) or ``"hannan-rissanen"`` (init only).  ``backend``:
    ``"cuda"`` (kernels), ``"eager"`` (plain PyTorch) or ``"auto"``
    (``cuda`` for a float32 panel on a CUDA device).  ``compact=False``
    turns straggler compaction off (it engages at batches >=
    ``_COMPACT_MIN_BATCH``).  ``align_mode`` (``"dense"`` /
    ``"no-trailing"`` / ``"general"``) skips the NaN probe; an unknown name
    raises and a hint too strong for the data flags rows (DIVERGED under
    ``"dense"``, EXCLUDED under ``"no-trailing"``), never corrupts them.

    ``count_evals=True`` returns ``(FitResult, info)``, the optimizer's
    pass accounting (``utils.optim.minimize_lbfgs_batched``), on either
    backend; ``method="hannan-rissanen"`` runs no optimizer and refuses it.

    ``FitResult.status`` holds per-row ``FitStatus`` codes (OK / DIVERGED /
    EXCLUDED).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if count_evals and method == "hannan-rissanen":
        raise ValueError("count_evals requires an optimizing method")
    if seasonal is not None and any(int(v) for v in tuple(seasonal)[:3]):
        raise NotImplementedError(
            "seasonal ARIMA is not ported yet (ROADMAP.md queue 1, item "
            "9); use spark_timeseries_tpu")
    p, d, q = order
    yb, single = ensure_batched(to_device(y, device))
    if tol is None:
        # f32 gradients of a ~1k-term CSS bottom out near 1e-4 relative noise
        tol = 1e-6 if yb.dtype == torch.float64 else 1e-4
    backend = resolve_backend(backend, yb,
                              structural_ok=ck.css_structural_ok(p, q))
    require_pallas_for_count_evals(count_evals, backend)
    align_mode = resolve_align_mode(yb, align_mode)
    with torch.no_grad():
        out = _fit_css(yb, order, include_intercept, method, backend,
                       max_iters, float(tol), init_params, align_mode,
                       compact, count_evals)
    return debatch_fit(out, single, count_evals)


def _css_prep(yb, init_params, order: Order, include_intercept: bool,
              backend: str, align_mode: str):
    """Front half of every CSS fit: align + difference, the one-time
    time-major layout (cuda backend), the Hannan-Rissanen (or caller's)
    init, the identifiability gate and the mean-scaling denominator.  The
    ``ok`` eligibility formula is the reference's, unchanged."""
    p, d, q = order
    k = _n_params(order, include_intercept)
    ya, nv0 = maybe_align(yb, align_mode)  # ragged: NaN head/tail
    yd = _difference(ya, d)
    nvd = nv0 - d  # valid length after differencing
    yt = zb = None
    if backend == "cuda":
        # one layout conversion per fit: the init sweeps and every
        # optimizer evaluation read this tensor
        yt, zb = ck.css_prefold(yd, order, nvd)
    if init_params is not None:
        init = torch.as_tensor(init_params, dtype=yd.dtype, device=yd.device)
        init = init.expand(yd.shape[0], k).clone()
    elif yt is not None and ck.hr_structural_ok(p, q):
        init = ck.hr_init(yd, order, include_intercept, nvd, yt=yt)
    else:
        init = hannan_rissanen_batched(yd, order, include_intercept, nvd)
    # too-short series cannot be fit: need lags + a few dof
    ok = nvd >= p + q + max(p + q + 1, 1) + k + 2
    if init_params is None:
        # HR's long-AR order m = min(p+q+1, n//4) comes from the PADDED
        # length; nvd >= 4*(p+q+1) keeps padded and trimmed inits identical
        ok = ok & (nvd >= 4 * (p + q + 1))
    # optimize the MEAN log-likelihood: same argmin, O(1) gradients
    n_eff = torch.clamp(nvd - p, min=1).to(yd.dtype)
    return yd, nvd, yt, zb, init, ok, n_eff


def _objective(backend, order, include_intercept, yd, nvd, yt, zb, n_eff):
    """The batched mean-CSS objective ``P [B, k] -> [B]`` and its straggler
    builder (``idxc -> objective over the gathered rows``)."""
    T = yd.shape[1]
    if backend == "cuda":
        def fb(P, yt=yt, zb=zb, nv=nvd, ne=n_eff):
            return ck.css_neg_loglik_folded(P, yt, zb, T, order,
                                            include_intercept, nv) / ne

        def straggler(idxc):
            # gather the stragglers' columns of the time-major panel once,
            # not at every evaluation of their objective
            sub = (yt[:, idxc].contiguous(), zb[idxc], nvd[idxc],
                   n_eff[idxc])
            return lambda P: fb(P, *sub)
    else:
        def fb(P, yd=yd, nv=nvd, ne=n_eff):
            return css_neg_loglik(P, yd, order, include_intercept, nv) / ne

        def straggler(idxc):
            sub = (yd[idxc], nvd[idxc], n_eff[idxc])
            return lambda P: fb(P, *sub)
    return fb, straggler


def _fit_css(yb, order: Order, include_intercept: bool, method: str,
             backend: str, max_iters: int, tol: float, init_params,
             align_mode: str, compact: bool, count_evals: bool = False):
    yd, nvd, yt, zb, init, ok, n_eff = _css_prep(
        yb, init_params, order, include_intercept, backend, align_mode)
    fb, straggler = _objective(backend, order, include_intercept, yd, nvd,
                               yt, zb, n_eff)
    if method == "hannan-rissanen":
        nll = fb(init) * n_eff
        params = torch.where(ok[:, None], init, torch.nan)
        z = torch.zeros(yd.shape[0], dtype=torch.int32, device=yd.device)
        return FitResult(params, torch.where(ok, nll, torch.nan), ok, z,
                         derive_status(ok, ok, params))
    bsz = yd.shape[0]
    if backend == "cuda":
        del yd  # the objective reads only the time-major copy
    gate = compact and bsz >= _COMPACT_MIN_BATCH
    res = optim.minimize_lbfgs_batched(
        fb, init, max_iters=max_iters, tol=tol, count_evals=count_evals,
        straggler_fun=straggler if gate else None,
        straggler_cap=optim.compaction_cap(bsz))
    res, info = res if count_evals else (res, None)
    params = torch.where(ok[:, None], res.x, torch.nan)
    out = FitResult(params, torch.where(ok, res.f * n_eff, torch.nan),
                    res.converged & ok, res.iters,
                    derive_status(ok, res.converged, params))
    return (out, info) if count_evals else out


# ---------------------------------------------------------------------------
# Forecasting
# ---------------------------------------------------------------------------


def forecast(params, y, order: Order, n_future: int,
             include_intercept: bool = True, *, backend: str = "auto",
             device="cuda"):
    """Forecast ``n_future`` steps ahead -> ``[batch?, n_future]``.

    In-sample errors are rebuilt with the CSS recursion (``condition=False``),
    then the ARMA recursion runs forward with future innovations at zero and
    the order-d differencing is inverted step by step.  Under ``"cuda"`` the
    rebuild is the forward kernel's ``tail`` mode (a read-only pass that
    emits only the last q errors).
    """
    yb, single = ensure_batched(to_device(y, device))
    params_b = to_device(params, device, dtype=yb.dtype)
    if params_b.ndim == 1:
        params_b = params_b[None, :]
    p, _, q = order
    backend = resolve_backend(backend, yb,
                              structural_ok=ck.css_structural_ok(p, q))
    with torch.no_grad():
        out = _forecast(order, n_future, include_intercept, backend,
                        align_mode_on_host(yb), params_b, yb)
    return out[0] if single else out


def _forecast(order, n_future, include_intercept, backend, align_mode,
              params_b, yb):
    p, d, q = order
    b = yb.shape[0]
    ya, nv0 = maybe_align(yb, align_mode)  # ragged: NaN head/tail
    yd = _difference(ya, d)
    nvd = nv0 - d
    n = yd.shape[1]
    start = (n - nvd).to(yd.dtype)
    # differencing across the padding boundary leaves garbage at
    # yd[start-1]; zero the prefix (same contract as the fit)
    t_idx = torch.arange(n, dtype=yd.dtype, device=yd.device)
    ydz = torch.where(t_idx[None, :] >= start[:, None], yd, 0.0)
    if q == 0:  # pure-AR forecasts never read past errors
        elast = yd.new_zeros(b, 1)
    elif backend == "cuda":
        params_k = ck.kernel_params(params_b, include_intercept).contiguous()
        # zb = start (not start + p) is exactly condition=False
        elast = ck.css_last_errors(p, q, params_k, ydz, start).flip(1)
    else:
        e = _css_errors(params_b, ydz, order, include_intercept,
                        condition=False, n_valid=nvd)
        elast = e.flip(1)[:, :q]
    c, phi, theta = _split_params(params_b, order, include_intercept)
    ydl = ydz.flip(1)[:, :p]  # last p differenced values, newest first
    levels = []  # last value of each difference level 0..d-1
    lv = ya
    for _ in range(d):
        levels.append(lv[:, -1])
        lv = lv[:, 1:] - lv[:, :-1]
    lvl = torch.stack(levels, dim=1) if d else yd.new_zeros(b, 0)
    el = elast
    out = []
    for _ in range(n_future):
        pred = c
        if p:
            pred = pred + (phi * ydl).sum(-1)
        if q:
            pred = pred + (theta * el).sum(-1)
        if p:
            ydl = torch.cat([pred[:, None], ydl[:, :-1]], dim=1)
        if q:
            el = torch.cat([el.new_zeros(b, 1), el[:, :-1]], dim=1)
        acc = pred
        new_lvl = lvl.clone()
        for i in reversed(range(d)):  # v_d = pred; v_i = lvl[i] + v_{i+1}
            acc = lvl[:, i] + acc
            new_lvl[:, i] = acc
        lvl = new_lvl
        out.append(acc)
    return torch.stack(out, dim=1)


# ---------------------------------------------------------------------------
# Host-side diagnostics
# ---------------------------------------------------------------------------


def _host(params) -> np.ndarray:
    if isinstance(params, torch.Tensor):
        return params.detach().cpu().numpy()
    return np.asarray(params)


def is_stationary(params, order: Order,
                  include_intercept: bool = True) -> np.ndarray:
    """AR-polynomial roots outside the unit circle (one series)."""
    p, _, _ = order
    if p == 0:
        return np.asarray(True)
    i = int(include_intercept)
    phi = _host(params)[i:i + p]
    if not np.all(np.isfinite(phi)):  # failed fit
        return np.asarray(False)
    roots = np.roots(np.concatenate([[1.0], -phi])[::-1])
    return np.asarray(np.all(np.abs(roots) > 1.0 + 1e-9))


def is_invertible(params, order: Order,
                  include_intercept: bool = True) -> np.ndarray:
    """MA-polynomial roots outside the unit circle (one series)."""
    p, _, q = order
    if q == 0:
        return np.asarray(True)
    i = int(include_intercept)
    theta = _host(params)[i + p:i + p + q]
    if not np.all(np.isfinite(theta)):  # failed fit
        return np.asarray(False)
    roots = np.roots(np.concatenate([[1.0], theta])[::-1])
    return np.asarray(np.all(np.abs(roots) > 1.0 + 1e-9))

"""ARIMA(p, d, q) and seasonal ARIMA: the flagship model family (port of
``models/arima.py``).

The whole panel is one batch: align -> difference -> Hannan-Rissanen init ->
lockstep batched L-BFGS on the mean CSS negative log-likelihood ->
``FitResult`` with per-row status.  Two backends compute the CSS objective:

- ``"cuda"``: the hand-written kernels (``ops.cuda_kernels``) on the
  time-major panel the fit builds once, with the adjoint kernel as the
  gradient and the moment kernel behind the init;
- ``"eager"``: plain PyTorch (:func:`css_neg_loglik`, differentiated by
  autograd; :func:`hannan_rissanen_batched`), on any device and dtype.

Seasonal orders (``fit(..., seasonal=(P, D, Q, s))``) and the fused order
grid (:func:`fit_grid`) expand their seasonal polynomials into plain lag
coefficients with differentiable PyTorch operations and run the same CSS
recursion: on ``"cuda"`` the same two kernels, one row of expanded
coefficients a series, so autograd carries the adjoint kernel's gradient
back through the expansion.

Parameter vector layout: ``[c (if intercept), phi_1..phi_p,
theta_1..theta_q]``, then ``PHI_1..P, THETA_1..Q`` for a seasonal order.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..ops import cuda_kernels as ck
from ..utils import optim
from ..utils.linalg import ridge_solve as _ridge_solve
from .base import (FitResult, align_mode_on_host, as_generator, debatch,
                   debatch_fit, derive_status, ensure_batched, maybe_align,
                   require_pallas_for_count_evals, resolve_align_mode,
                   resolve_backend, to_device)

Order = Tuple[int, int, int]
Seasonal = Tuple[int, int, int, int]  # (P, D, Q, s)

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


# ---------------------------------------------------------------------------
# CSS likelihood (the eager backend's objective)
# ---------------------------------------------------------------------------


def _css_errors_poly(c, phi, theta, yd, condition: bool = True,
                     n_valid=None, condition_lags=None):
    """One-step-ahead prediction errors ``[B, n]`` of the ARMA recursion
    with lag-coefficient rows ``phi [B, p]`` / ``theta [B, q]``: the one
    recursion the plain fit, the seasonal fit (expanded polynomials) and
    the grid fit (coefficients zero-padded to the grid's depth) run.

    ``condition=True`` zeroes the errors of the first ``p`` valid steps
    (the conditional likelihood); ``condition=False`` keeps every valid
    step.  ``n_valid [B]`` marks a right-aligned valid span: the prefix of
    ``yd`` before it is zeroed and its errors forced to 0.
    ``condition_lags`` (an int or ``[B]``) overrides the conditioning
    depth: a grid order padded to the grid's depth still conditions out
    only its own ``p_full`` steps.
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
    ypad = torch.nn.functional.pad(yd, (p, 0))  # lags before t=0 read 0
    cond_p = p if condition_lags is None else condition_lags
    zero_before = start + cond_p if condition else start
    errs = yd.new_zeros(b, q)  # newest first
    out = []
    for t in range(n):
        pred = c + (phi * ypad[:, t:t + p].flip(-1)).sum(-1)
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
    return _concentrated((e * e).sum(-1), nv - p)


def approx_aic(params, yd, order: Order, include_intercept: bool):
    k = _n_params(order, include_intercept)
    return 2.0 * css_neg_loglik(params, yd, order, include_intercept) + 2.0 * k


def _concentrated(css, n_eff):
    """The Gaussian negative log-likelihood with the innovation variance
    concentrated out (sigma^2 = CSS / n_eff)."""
    sigma2 = css / n_eff
    return 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)


# ---------------------------------------------------------------------------
# Seasonal extension: SARIMA(p,d,q)(P,D,Q)_s through the same recursion
# ---------------------------------------------------------------------------
#
# Phi(L^s) phi(L) (1-L)^d (1-L^s)^D y_t = c + Theta(L^s) theta(L) e_t: the
# seasonal polynomials are expanded into plain lag coefficients (p+P*s AR
# lags, q+Q*s MA lags) and run through the CSS recursion of the plain fit,
# with its conditioning rule and its concentrated likelihood.


def _validate_seasonal(seasonal) -> Optional[Seasonal]:
    """Normalize a ``(P, D, Q, s)`` seasonal spec; ``None`` (or an all-zero
    structure) means "no seasonal terms" and returns None."""
    if seasonal is None:
        return None
    try:
        P, D, Q, s = (int(v) for v in seasonal)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"seasonal must be a (P, D, Q, s) tuple, got {seasonal!r}") from e
    if P == 0 and D == 0 and Q == 0:
        return None
    if min(P, D, Q) < 0:
        raise ValueError(f"seasonal orders must be >= 0, got {seasonal!r}")
    if s < 2:
        raise ValueError(
            f"seasonal period s must be >= 2 when (P, D, Q) != 0, "
            f"got {seasonal!r}")
    return (P, D, Q, s)


def _difference_seasonal(y, D: int, s: int):
    """Order-D seasonal differencing at lag s along the last axis (drops
    D*s entries)."""
    for _ in range(D):
        y = y[..., s:] - y[..., :-s]
    return y


def _n_params_seasonal(order: Order, seasonal: Seasonal,
                       include_intercept: bool) -> int:
    p, _, q = order
    P, _, Q, _ = seasonal
    return int(include_intercept) + p + q + P + Q


def _split_params_seasonal(params, order: Order, seasonal: Seasonal,
                           include_intercept: bool):
    """``[..., k]`` -> ``(c, phi, theta, PHI, THETA)``; the non-seasonal
    prefix is :func:`_split_params`'s, so a plain ARMA fit can warm-start
    a seasonal one."""
    p, _, q = order
    P, _, Q, _ = seasonal
    i = int(include_intercept)
    c = (params[..., 0] if include_intercept
         else params.new_zeros(params.shape[:-1]))
    j = i + p + q
    return (c, params[..., i:i + p], params[..., i + p:j],
            params[..., j:j + P], params[..., j + P:j + P + Q])


def _expand_seasonal_poly(vals, svals, s: int, cross: float):
    """Lag coefficients ``[..., p + P*s]`` of the multiplicative polynomial
    product, from ``vals [..., p]`` and ``svals [..., P]``.

    AR side (``cross=-1``): ``(1 - sum v_i L^i)(1 - sum w_j L^js)`` gives
    ``a[:p] = v``, ``a[js-1] = w_j``, ``a[js+i-1] = -v_i w_j``; the MA side
    (``cross=+1``) adds the cross terms.  Each term is added zero-padded to
    the full depth (out of place), so autograd carries a gradient of the
    expanded coefficients back to ``vals`` and ``svals``.
    """
    pad = torch.nn.functional.pad
    p, P = vals.shape[-1], svals.shape[-1]
    n = p + P * s
    full = pad(vals, (0, n - p))
    for j in range(P):
        lag = (j + 1) * s
        w = svals[..., j:j + 1]
        full = full + pad(w, (lag - 1, n - lag))
        if p:
            full = full + pad(cross * w * vals, (lag, n - lag - p))
    return full


def _expanded(params, order: Order, seasonal: Optional[Seasonal],
              include_intercept: bool):
    """``[..., k]`` packed parameters (columns past ``k`` ignored) ->
    ``(c, phi_full, theta_full)``: the lag coefficients the recursion
    runs."""
    if seasonal is None:
        return _split_params(params, order, include_intercept)
    s = seasonal[3]
    c, phi, theta, sphi, stheta = _split_params_seasonal(
        params, order, seasonal, include_intercept)
    return (c, _expand_seasonal_poly(phi, sphi, s, -1.0),
            _expand_seasonal_poly(theta, stheta, s, 1.0))


def _lag_support(order: Order, seasonal: Optional[Seasonal]
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(ar_lags, ma_lags)``: the sorted lags whose expanded coefficient
    the order can make non-zero, ``{1..p} | {js} | {js + i}`` a side (j up
    to P or Q, i up to p or q).  Decided from the order alone, never from
    the values: a free coefficient may sit at exactly 0 (the seasonal
    terms start there) and still needs its gradient."""
    p, _, q = order
    P, _, Q, s = seasonal if seasonal is not None else (0, 0, 0, 0)

    def side(n, N):
        return tuple(sorted({*range(1, n + 1),
                             *(j * s + i for j in range(1, N + 1)
                               for i in range(n + 1))}))

    return side(p, P), side(q, Q)


def _sarima_css_errors(params, yd, order: Order, seasonal: Seasonal,
                       include_intercept: bool, condition: bool = True,
                       n_valid=None):
    """CSS errors ``[B, n]`` of the expanded seasonal recursion (``yd``
    already plain- and seasonally differenced)."""
    return _css_errors_poly(
        *_expanded(params, order, seasonal, include_intercept), yd,
        condition=condition, n_valid=n_valid)


def seasonal_lag_span(order: Order, seasonal: Optional[Seasonal]
                      ) -> Tuple[int, int, int]:
    """``(p_full, q_full, d_full)``: the expanded AR/MA lag depths and the
    total differencing the (optionally seasonal) model conditions on."""
    p, d, q = order
    if seasonal is None:
        return p, q, d
    P, D, Q, s = seasonal
    return p + P * s, q + Q * s, d + D * s


def sarima_neg_loglik(params, yd, order: Order, seasonal: Seasonal,
                      include_intercept: bool, n_valid=None):
    """Concentrated CSS likelihood ``[B]`` of the seasonal recursion: the
    rule of :func:`css_neg_loglik` with the expanded AR depth ``p + P*s``
    conditioned out."""
    p_full, _, _ = seasonal_lag_span(order, seasonal)
    nv = (torch.full((yd.shape[0],), yd.shape[1], dtype=yd.dtype,
                     device=yd.device)
          if n_valid is None else n_valid.to(yd.dtype))
    e = _sarima_css_errors(params, yd, order, seasonal, include_intercept,
                           n_valid=n_valid)
    return _concentrated((e * e).sum(-1), nv - p_full)


def _sarima_kernel_params(params, order: Order,
                          seasonal: Optional[Seasonal],
                          include_intercept: bool):
    """``[B, k]`` packed parameters -> the CSS kernels' rows ``[B, 1 +
    p_full + q_full]`` of ``[c, expanded phi, expanded theta]`` (a plain
    order's ``[c, phi, theta]`` when ``seasonal`` is None)."""
    c, phi, theta = _expanded(params, order, seasonal, include_intercept)
    return torch.cat([c[:, None], phi, theta], dim=1).contiguous()


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


def hannan_rissanen(yd, order: Order, include_intercept: bool, n_valid=None):
    """Two-stage startup values ``[k]`` of one differenced series ``[n]``
    (optionally right-aligned with ``n_valid`` valid steps): the weighted
    normal equations of :func:`hannan_rissanen_batched` on one row."""
    yd = torch.as_tensor(yd)
    n = yd.shape[-1]
    nv = torch.as_tensor(n if n_valid is None else n_valid,
                         device=yd.device).reshape(1)
    return hannan_rissanen_batched(yd.reshape(1, n), order,
                                   include_intercept, nv)[0]


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

    ``seasonal=(P, D, Q, s)`` adds multiplicative seasonal terms (SARIMA):
    the panel is differenced d times, then D times at lag s, and the
    expanded polynomials run the CSS recursion, on either backend (the
    kernels for ``"cuda"``; the reference runs them on its portable
    backend only).  An optimizing method only, without ``count_evals``.

    ``FitResult.status`` holds per-row ``FitStatus`` codes (OK / DIVERGED /
    EXCLUDED).
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if count_evals and method == "hannan-rissanen":
        raise ValueError("count_evals requires an optimizing method")
    seasonal = _validate_seasonal(seasonal)
    with obs.span("fit.arima") as sp:
        if seasonal is not None:
            return _fit_seasonal(
                y, order, seasonal, include_intercept, method=method,
                init_params=init_params, max_iters=max_iters, tol=tol,
                backend=backend, count_evals=count_evals, compact=compact,
                align_mode=align_mode, device=device, span=sp)
        p, d, q = order
        yb, single = ensure_batched(to_device(y, device))
        if tol is None:
            # f32 gradients of a ~1k-term CSS bottom out near 1e-4
            # relative noise
            tol = 1e-6 if yb.dtype == torch.float64 else 1e-4
        backend = resolve_backend(backend, yb,
                                  structural_ok=ck.css_structural_ok(p, q))
        sp.set(rows=yb.shape[0], time=yb.shape[1], backend=backend)
        require_pallas_for_count_evals(count_evals, backend)
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
            optim.count_objective(P, T)
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
            optim.count_objective(P, T)
            return css_neg_loglik(P, yd, order, include_intercept, nv) / ne

        def straggler(idxc):
            sub = (yd[idxc], nvd[idxc], n_eff[idxc])
            return lambda P: fb(P, *sub)
    return fb, straggler


def _fit_css(yb, order: Order, include_intercept: bool, method: str,
             backend: str, max_iters: int, tol: float, init_params,
             align_mode: Optional[str], compact: bool,
             count_evals: bool = False):
    """The plain CSS fit of a batched panel: its preparation (``align_mode``
    ``None`` probes the panel), the optimizer and the finalization, each in
    its span."""
    with obs.span("fit.prep"):
        align_mode = resolve_align_mode(yb, align_mode)
        yd, nvd, yt, zb, init, ok, n_eff = _css_prep(
            yb, init_params, order, include_intercept, backend, align_mode)
        fb, straggler = _objective(backend, order, include_intercept, yd,
                                   nvd, yt, zb, n_eff)
    if method == "hannan-rissanen":
        with obs.span("fit.finalize"):
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
    with obs.span("fit.finalize"):
        out = _finalize_css_fit(res, ok, n_eff)
    return (out, info) if count_evals else out


def _finalize_css_fit(res, ok, n_eff) -> FitResult:
    """Optimizer result -> FitResult: gated rows NaN, the unscaled nll."""
    params = torch.where(ok[:, None], res.x, torch.nan)
    return FitResult(params, torch.where(ok, res.f * n_eff, torch.nan),
                     res.converged & ok, res.iters,
                     derive_status(ok, res.converged, params))


def _fit_seasonal(y, order: Order, seasonal: Seasonal,
                  include_intercept: bool, *, method: str, init_params,
                  max_iters: int, tol: Optional[float], backend: str,
                  count_evals: bool, compact: bool,
                  align_mode: Optional[str], device,
                  span=obs.NULL_SPAN) -> FitResult:
    """Seasonal branch of :func:`fit` (validated ``seasonal`` only), with
    the reference's refusals; ``span`` is the caller's ``fit.arima``."""
    if method == "hannan-rissanen":
        raise ValueError(
            "seasonal orders require an optimizing CSS method "
            "(hannan-rissanen has no seasonal init stage)")
    if count_evals:
        raise ValueError(
            "count_evals is not available for seasonal orders (the "
            "reference's seasonal fit keeps no pass accounting)")
    p_full, q_full, d_full = seasonal_lag_span(order, seasonal)
    yb, single = ensure_batched(to_device(y, device))
    if yb.shape[1] - d_full < max(p_full + q_full + 2, 2):
        raise ValueError(
            f"series of length {yb.shape[1]} too short for seasonal order "
            f"{order} x {seasonal} (needs > {d_full + p_full + q_full + 2} "
            "observations)")
    if tol is None:
        tol = 1e-6 if yb.dtype == torch.float64 else 1e-4
    backend = resolve_backend(backend, yb,
                              structural_ok=ck.css_structural_ok(p_full,
                                                                 q_full))
    span.set(rows=yb.shape[0], time=yb.shape[1], backend=backend)
    with torch.no_grad():
        out = _fit_sarima(yb, order, seasonal, include_intercept, backend,
                          max_iters, float(tol), init_params, align_mode,
                          compact)
    return debatch(out, single)


def _fit_sarima(yb, order: Order, seasonal: Seasonal,
                include_intercept: bool, backend: str, max_iters: int,
                tol: float, init_params, align_mode: Optional[str],
                compact: bool):
    """Align (``align_mode`` ``None`` probes the panel), both
    differencings, the non-seasonal Hannan-Rissanen warm start (the P + Q
    seasonal terms start at 0), the reference's identifiability gate, and
    the batched L-BFGS on the expanded-polynomial objective, with straggler
    compaction as in the plain fit."""
    with obs.span("fit.prep"):
        align_mode = resolve_align_mode(yb, align_mode)
        p, d, q = order
        P, D, Q, s = seasonal
        k = _n_params_seasonal(order, seasonal, include_intercept)
        p_full, q_full, d_full = seasonal_lag_span(order, seasonal)
        ya, nv0 = maybe_align(yb, align_mode)  # ragged: NaN head/tail
        yd = _difference_seasonal(_difference(ya, d), D, s)
        del ya
        nvd = nv0 - d_full  # valid length after both differencings
        bsz, T = yd.shape
        yt = zb = None
        if backend == "cuda":
            yt, zb = ck.css_prefold(yd, (p_full, 0, q_full), nvd)
        if init_params is not None:
            init = torch.as_tensor(init_params, dtype=yd.dtype,
                                   device=yd.device)
            init = init.expand(bsz, k).clone()
        else:
            if yt is not None and ck.hr_structural_ok(p, q):
                base = ck.hr_init(yd, (p, 0, q), include_intercept, nvd,
                                  yt=yt)
            else:
                base = hannan_rissanen_batched(yd, (p, 0, q),
                                               include_intercept, nvd)
            init = torch.cat([base, base.new_zeros(bsz, P + Q)], dim=1)
        ok = nvd >= p_full + q_full + max(p_full + q_full + 1, 1) + k + 2
        if init_params is None:
            ok = ok & (nvd >= 4 * (p + q + 1))
        n_eff = torch.clamp(nvd - p_full, min=1).to(yd.dtype)
        if backend == "cuda":
            lags = _lag_support(order, seasonal)

            def fb(P_, yt=yt, zb=zb, nv=nvd, ne=n_eff):
                optim.count_objective(P_, T)
                kp = _sarima_kernel_params(P_, order, seasonal,
                                           include_intercept)
                css = ck.css_sse_folded(kp, yt, zb, p_full, q_full, lags=lags)
                return _concentrated(css, nv.to(kp.dtype) - p_full) / ne

            def straggler(idxc):
                sub = (yt[:, idxc].contiguous(), zb[idxc], nvd[idxc],
                       n_eff[idxc])
                return lambda P_: fb(P_, *sub)
            del yd  # the objective reads only the time-major copy
        else:
            def fb(P_, yd=yd, nv=nvd, ne=n_eff):
                optim.count_objective(P_, T)
                return sarima_neg_loglik(P_, yd, order, seasonal,
                                         include_intercept, nv) / ne

            def straggler(idxc):
                sub = (yd[idxc], nvd[idxc], n_eff[idxc])
                return lambda P_: fb(P_, *sub)
    gate = compact and bsz >= _COMPACT_MIN_BATCH
    res = optim.minimize_lbfgs_batched(
        fb, init, max_iters=max_iters, tol=tol,
        straggler_fun=straggler if gate else None,
        straggler_cap=optim.compaction_cap(bsz))
    with obs.span("fit.finalize"):
        return _finalize_css_fit(res, ok, n_eff)


# ---------------------------------------------------------------------------
# Fused multi-order grid fit: K same-d orders, one lockstep optimizer
# ---------------------------------------------------------------------------
#
# fit_grid makes the candidate grid of an order search a batch dimension:
# K orders that share the plain differencing order d are fitted together,
# as one lockstep batched L-BFGS over the flattened [K*B] cell grid.  The
# panel is differenced once per (d, D, s) signature; seasonal variants are
# right-aligned into the common length.  Every order's lag coefficients
# are expanded and, where cells of different orders meet in one problem,
# zero-padded to the grid's depth, while each order keeps conditioning on
# its own p_full.  The K per-order results are packed per row — [params
# (k_max), nll, eligible, converged, iters, status] an order — so a fused
# chunk rides a single-result driver unchanged; models.auto demuxes it.

GRID_PACK_COLS = 5  # nll, eligible, converged, iters, status per order

# module-level so tests can monkeypatch the gate of the grid's straggler
# compaction (in cells); the cap rule is the reference's
_GRID_COMPACT_MIN_CELLS = 512


def _grid_spec_info(order: Order, seasonal: Optional[Seasonal],
                    include_intercept: bool) -> dict:
    p, d, q = order
    seasonal = _validate_seasonal(seasonal)
    if seasonal is None:
        k = _n_params(order, include_intercept)
        P = D = Q = s = 0
    else:
        P, D, Q, s = seasonal
        k = _n_params_seasonal(order, seasonal, include_intercept)
    p_full, q_full, d_full = seasonal_lag_span(order, seasonal)
    return dict(order=(p, d, q), seasonal=seasonal, k=k, P=P, D=D, Q=Q, s=s,
                p_full=p_full, q_full=q_full, d_full=d_full)


def grid_pack_width(specs, include_intercept: bool = True) -> int:
    """Packed-row width of a :func:`fit_grid` result for ``specs``."""
    infos = [_grid_spec_info(tuple(o), sea, include_intercept)
             for o, sea in specs]
    k_max = max(i["k"] for i in infos)
    return len(infos) * (k_max + GRID_PACK_COLS)


def grid_diff_cache_keys(specs) -> int:
    """Distinct differencing signatures ``(d, D, s)`` a fused group of
    ``specs`` needs: the group differences the panel once per key."""
    keys = set()
    for order, seasonal in specs:
        seasonal = _validate_seasonal(seasonal)
        d = int(order[1])
        if seasonal is None or seasonal[1] == 0:
            keys.add((d, 0, 0))
        else:
            keys.add((d, int(seasonal[1]), int(seasonal[3])))
    return len(keys)


def _grid_coef_maps(infos, include_intercept: bool, k_max: int, p_max: int,
                    q_max: int):
    """Per-order packed-params -> expanded-lag-coefficient maps, as numpy
    constants: ``phi_full = lin_phi[g] @ P + P^T quad_phi[g] P`` (the theta
    analog with cross ``+1``), ``c = lin_c[g] @ P``.

    The seasonal expansion is linear in the own-lag and seasonal
    coefficients plus bilinear cross terms, so per order it is exactly a
    (linear, quadratic-form) pair of 0/+-1 tensors: the grid objective
    becomes one per-cell computation that a straggler gather can index by
    cell, across mixed orders."""
    K = len(infos)
    lin_c = np.zeros((K, k_max), np.float32)
    lin_phi = np.zeros((K, max(p_max, 1), k_max), np.float32)
    quad_phi = np.zeros((K, max(p_max, 1), k_max, k_max), np.float32)
    lin_th = np.zeros((K, max(q_max, 1), k_max), np.float32)
    quad_th = np.zeros((K, max(q_max, 1), k_max, k_max), np.float32)
    i0 = int(include_intercept)
    for g, info in enumerate(infos):
        p, _, q = info["order"]
        P, Q, s = info["P"], info["Q"], info["s"]
        if include_intercept:
            lin_c[g, 0] = 1.0
        for i in range(p):
            lin_phi[g, i, i0 + i] = 1.0
        for j in range(q):
            lin_th[g, j, i0 + p + j] = 1.0
        for j in range(P):  # seasonal AR: lag (j+1)s - 1, cross = -1
            lag = (j + 1) * s
            lin_phi[g, lag - 1, i0 + p + q + j] += 1.0
            for i in range(p):
                quad_phi[g, lag + i, i0 + p + q + j, i0 + i] += -1.0
        for j in range(Q):  # seasonal MA: cross = +1
            lag = (j + 1) * s
            lin_th[g, lag - 1, i0 + p + q + P + j] += 1.0
            for i in range(q):
                quad_th[g, lag + i, i0 + p + q + P + j, i0 + p + i] += 1.0
    return lin_c, lin_phi, quad_phi, lin_th, quad_th


def _grid_lag_union(maps, p_max: int, q_max: int):
    """``(ar_lags, ma_lags)`` the grid's compacted launches read: the lag
    slots that any order's (linear, quadratic) map of
    :func:`_grid_coef_maps` (host constants) can make non-zero."""
    _, lin_phi, quad_phi, lin_th, quad_th = maps

    def side(lin, quad, n):
        return tuple(k + 1 for k in range(n)
                     if lin[:, k].any() or quad[:, k].any())

    return side(lin_phi, quad_phi, p_max), side(lin_th, quad_th, q_max)


def fit_grid(y, specs, include_intercept: bool = True, *,
             method: str = "css-lbfgs", max_iters: int = 60,
             tol: Optional[float] = None, backend: str = "auto",
             align_mode: Optional[str] = None,
             device="cuda") -> FitResult:
    """Fit a fused grid of K same-``d`` (S)ARIMA candidates together.

    ``specs`` is a sequence of ``(order, seasonal_or_None)`` pairs that
    share the plain differencing order ``d`` (seasonal ``(D, s)`` may
    vary: each distinct ``(d, D, s)`` signature differences the panel
    once).  Returns a :class:`FitResult` whose ``params`` pack the K
    per-order results per row, all finite, with per-order eligibility as
    its own column (layout :data:`GRID_PACK_COLS`, width
    :func:`grid_pack_width`); the row-level nll / converged / iters /
    status give the row's best outcome across the grid (min nll / any
    converged / max iters / min-severity status).

    ``backend``: ``"cuda"`` runs one forward and one adjoint launch of the
    CSS kernels a order and pass, each at its own ``(p_full, q_full)`` over
    its signature's time-major panel; ``"eager"`` runs the plain recursion;
    ``"auto"`` takes ``"cuda"`` for a float32 panel on the card (the
    reference runs the grid on its portable backend only).  Straggler
    compaction engages for one signature at ``_GRID_COMPACT_MIN_CELLS``
    cells or more, with the reference's cap.
    """
    if method not in ("css-lbfgs", "css-cgd", "css-bobyqa"):
        raise ValueError(
            f"fit_grid requires an optimizing CSS method, got {method!r}")
    specs = tuple((tuple(int(v) for v in o), _validate_seasonal(sea))
                  for o, sea in specs)
    if not specs:
        raise ValueError("fit_grid needs at least one order spec")
    d0 = specs[0][0][1]
    if any(o[1] != d0 for o, _ in specs):
        raise ValueError(
            f"fit_grid fuses same-d orders only (shared differencing); got "
            f"d values {sorted({o[1] for o, _ in specs})}")
    yb, single = ensure_batched(to_device(y, device))
    if tol is None:
        tol = 1e-6 if yb.dtype == torch.float64 else 1e-4
    infos = [_grid_spec_info(o, sea, include_intercept) for o, sea in specs]
    p_max = max(i["p_full"] for i in infos)
    q_max = max(i["q_full"] for i in infos)
    backend = resolve_backend(backend, yb,
                              structural_ok=ck.css_structural_ok(p_max, q_max))
    align_mode = resolve_align_mode(yb, align_mode)
    with torch.no_grad():
        out = _fit_grid(yb, infos, include_intercept, backend, max_iters,
                        float(tol), align_mode)
    return debatch(out, single)


def _grid_sig(info) -> tuple:
    return (info["D"], info["s"]) if info["D"] else (0, 0)


def _fit_grid(yb, infos, include_intercept: bool, backend: str,
              max_iters: int, tol: float, align_mode: str) -> FitResult:
    K = len(infos)
    d = infos[0]["order"][1]
    k_max = max(i["k"] for i in infos)
    p_max = max(i["p_full"] for i in infos)
    q_max = max(i["q_full"] for i in infos)
    any_seasonal = any(i["seasonal"] is not None for i in infos)
    bsz, t_len = yb.shape
    ya, nv0 = maybe_align(yb, align_mode)  # ragged: NaN head/tail
    n = t_len - d
    yd_plain = _difference(ya, d)
    del ya
    # one differenced panel a (d, D, s) signature; seasonal variants are
    # right-aligned into the common length n, and their zero-filled head
    # lies before the signature's start, where the recursion reads zeros.
    # On the cuda backend each signature is converted to the kernels'
    # layout once; its prefix is zeroed from the signature's own nvd.
    sigs = {}
    for info in infos:
        key = _grid_sig(info)
        if key in sigs:
            continue
        D, s = key
        yd = yd_plain
        if D:
            yd = _difference_seasonal(yd_plain, D, s)
            yd = torch.nn.functional.pad(yd, (n - yd.shape[1], 0))
        sig = {"yd": yd, "nvd": nv0 - info["d_full"]}
        if backend == "cuda":
            sig["yt"], sig["start"] = ck.css_prefold(yd, (0, 0, 0),
                                                     sig["nvd"])
        sigs[key] = sig
    del yd_plain
    # shared-prep accounting: orders that reused another order's
    # differencing (the reference's counter, once per call here)
    if K > len(sigs):
        obs.counter("auto_fit.diff_cache_hits").add(K - len(sigs))
    inits, oks, n_effs, nvds = [], [], [], []
    for info in infos:
        p, _, q = info["order"]
        sig = sigs[_grid_sig(info)]
        nvd = sig["nvd"]
        # non-seasonal Hannan-Rissanen warm start on the (fully)
        # differenced panel; the seasonal terms start at 0
        if backend == "cuda" and ck.hr_structural_ok(p, q):
            base = ck.hr_init(sig["yd"], (p, 0, q), include_intercept, nvd,
                              yt=sig["yt"])
        else:
            base = hannan_rissanen_batched(sig["yd"], (p, 0, q),
                                           include_intercept, nvd)
        base = torch.cat([base, base.new_zeros(bsz, info["P"] + info["Q"])],
                         dim=1)
        # zero-padded to k_max: the objective never reads the pad, so its
        # gradient, and with it its trajectory, stays exactly 0
        inits.append(torch.nn.functional.pad(base, (0, k_max - info["k"])))
        pf, qf, k = info["p_full"], info["q_full"], info["k"]
        ok = nvd >= pf + qf + max(pf + qf + 1, 1) + k + 2
        oks.append(ok & (nvd >= 4 * (p + q + 1)))
        n_effs.append(torch.clamp(nvd - pf, min=1).to(base.dtype))
        nvds.append(nvd)
    dtype, dev = inits[0].dtype, inits[0].device
    if backend == "cuda":
        for sig in sigs.values():
            del sig["yd"]  # the objectives read the time-major copies only
        zbs = [sigs[_grid_sig(i)]["start"] + i["p_full"] for i in infos]
        supports = [_lag_support(i["order"], i["seasonal"]) for i in infos]

        def fb(p_flat):
            pk = p_flat.reshape(K, bsz, k_max)
            out = []
            for g, info in enumerate(infos):
                kp = _sarima_kernel_params(pk[g], info["order"],
                                           info["seasonal"],
                                           include_intercept)
                css = ck.css_sse_folded(kp, sigs[_grid_sig(info)]["yt"],
                                        zbs[g], info["p_full"],
                                        info["q_full"], lags=supports[g])
                out.append(_concentrated(css, n_effs[g]) / n_effs[g])
            return torch.cat(out)
    else:
        # the orders of one signature share its panel; the eager recursion
        # runs them as one [K_sig * B] batch
        by_sig: dict = {}
        for g, info in enumerate(infos):
            by_sig.setdefault(_grid_sig(info), []).append(g)
        tiled = {key: (sigs[key]["yd"].repeat(len(gs), 1),
                       torch.cat([nvds[g] for g in gs]),
                       torch.cat([torch.full((bsz,), infos[g]["p_full"],
                                             dtype=torch.long, device=dev)
                                  for g in gs]),
                       torch.cat([n_effs[g] for g in gs]))
                 for key, gs in by_sig.items()}

        def fb(p_flat):
            pk = p_flat.reshape(K, bsz, k_max)
            out = [None] * K
            for key, gs in by_sig.items():
                ydk, nvk, cpk, nek = tiled[key]
                parts = [_expanded(pk[g], infos[g]["order"],
                                   infos[g]["seasonal"], include_intercept)
                         for g in gs]
                c = torch.cat([pt[0] for pt in parts])
                phi = torch.cat([torch.nn.functional.pad(
                    pt[1], (0, p_max - pt[1].shape[1])) for pt in parts])
                theta = torch.cat([torch.nn.functional.pad(
                    pt[2], (0, q_max - pt[2].shape[1])) for pt in parts])
                e = _css_errors_poly(c, phi, theta, ydk, n_valid=nvk,
                                     condition_lags=cpk)
                nll = _concentrated((e * e).sum(-1), nek) / nek
                for j, g in enumerate(gs):
                    out[g] = nll[j * bsz:(j + 1) * bsz]
            return torch.cat(out)

    # straggler compaction over the flattened [K*B] cell grid: once at most
    # `cap` cells remain, they are gathered into one problem whose
    # objective rebuilds each cell's expanded coefficients from its order's
    # (linear, quadratic) maps and runs the recursion at the grid's depth
    # (p_max, q_max) with each cell's own conditioning start.  Autograd
    # through the maps gives the slots an order does not have a zero
    # gradient.  Single-signature groups only, as in the reference.
    cells = K * bsz
    cap = None
    if len(sigs) == 1 and cells >= _GRID_COMPACT_MIN_CELLS:
        # cells/4, 128-aligned: a whole order can sit converged while
        # another runs, so the tail is fat
        cap = -(-max(128, cells // 4) // 128) * 128
        if cap >= cells:
            cap = None
    straggler_fun = None
    if cap is not None:
        (sig0,) = sigs.values()
        np_maps = _grid_coef_maps(infos, include_intercept, k_max, p_max,
                                  q_max)
        union = _grid_lag_union(np_maps, p_max, q_max)
        maps = [torch.as_tensor(m, dtype=dtype, device=dev) for m in np_maps]
        nvd_all = torch.cat(nvds)
        ne_all = torch.cat(n_effs)
        cp_all = torch.cat([torch.full((bsz,), i["p_full"], dtype=torch.long,
                                       device=dev) for i in infos])

        def straggler_fun(idxc):
            gcell, rcell = idxc // bsz, idxc % bsz
            lc, lphi, qphi, lth, qth = (m[gcell] for m in maps)
            ne_s, cp_s = ne_all[idxc], cp_all[idxc]
            if backend == "cuda":
                data = (sig0["yt"][:, rcell].contiguous(),
                        sig0["start"][rcell] + cp_s.to(dtype))
            else:
                data = (sig0["yd"][rcell], nvd_all[idxc])

            def fb_s(p_sub):
                # the maps' contractions (the reference's einsums) as
                # broadcast products: over ~10^6 cells, einsum's batched
                # matrix-vector products run as many small cuBLAS launches
                c = (lc * p_sub).sum(-1)
                phi = (lphi * p_sub[:, None, :]).sum(-1)
                theta = (lth * p_sub[:, None, :]).sum(-1)
                if any_seasonal:
                    outer = (p_sub[:, :, None] * p_sub[:, None, :])[:, None]
                    phi = phi + (qphi * outer).sum((-2, -1))
                    theta = theta + (qth * outer).sum((-2, -1))
                phi, theta = phi[:, :p_max], theta[:, :q_max]
                if backend == "cuda":
                    kp = torch.cat([c[:, None], phi, theta],
                                   dim=1).contiguous()
                    css = ck.css_sse_folded(kp, data[0], data[1], p_max,
                                            q_max, lags=union)
                else:
                    e = _css_errors_poly(c, phi, theta, data[0],
                                         n_valid=data[1], condition_lags=cp_s)
                    css = (e * e).sum(-1)
                return _concentrated(css, ne_s) / ne_s

            return fb_s

    res = optim.minimize_lbfgs_batched(
        fb, torch.cat(inits), max_iters=max_iters, tol=tol,
        straggler_fun=straggler_fun, straggler_cap=cap)
    return _grid_pack(res, infos, oks, n_effs, k_max, bsz)


def _grid_pack(res, infos, oks, n_effs, k_max: int, bsz: int) -> FitResult:
    """The K per-order results packed per row, with the best-outcome row
    summaries (the reference's layout, column for column)."""
    K = len(infos)
    xk = res.x.reshape(K, bsz, k_max)
    fk = res.f.reshape(K, bsz)
    convk = res.converged.reshape(K, bsz)
    itk = res.iters.reshape(K, bsz)
    blocks, nlls, convs, statuses = [], [], [], []
    for g, info in enumerate(infos):
        ok = oks[g]
        colmask = torch.arange(k_max, device=xk.device) < info["k"]
        params_g = torch.where(ok[:, None] & colmask[None, :], xk[g],
                               torch.nan)
        nll_g = torch.where(ok, fk[g] * n_effs[g], torch.nan)
        conv_g = convk[g] & ok
        # status judges this order's own columns: the k_max padding is
        # NaN by the pack convention and must not read as divergence
        status_g = derive_status(
            ok, convk[g], torch.where(colmask[None, :], params_g, 0.0))
        # the pack is all-finite (a resilient runner marks a row failed on
        # any non-finite value); eligibility rides as its own column
        elig_g = ok & torch.isfinite(nll_g)
        dt = params_g.dtype
        blocks += [torch.where(torch.isfinite(params_g), params_g, 0.0),
                   torch.where(elig_g, nll_g, 0.0)[:, None],
                   elig_g.to(dt)[:, None], conv_g.to(dt)[:, None],
                   itk[g].to(dt)[:, None], status_g.to(dt)[:, None]]
        nlls.append(torch.where(elig_g, nll_g, torch.nan))
        convs.append(conv_g)
        statuses.append(status_g)
    wide = torch.cat(blocks, dim=1)  # [B, K*(k_max+5)]
    nll_all = torch.stack(nlls)
    best = torch.where(torch.isnan(nll_all), torch.inf, nll_all).amin(0)
    return FitResult(wide, torch.where(torch.isfinite(best), best, torch.nan),
                     torch.stack(convs).any(0), itk.amax(0),
                     torch.stack(statuses).amin(0))


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
# Sampling and the effects transforms
# ---------------------------------------------------------------------------


def sample(params, gen, n: int, order: Order, include_intercept: bool = True,
           sigma: float = 1.0, *, device="cuda"):
    """Simulate a series of length ``n`` from the model with N(0, sigma^2)
    innovations (``ARIMAModel.sample``); ``params [k]`` gives ``[n]``,
    ``params [B, k]`` gives ``[B, n]``.  The draws come from ``gen``, a
    ``torch.Generator`` on ``device`` or an integer seed; they are not the
    reference's (JAX keys), their distribution is the same."""
    pb = to_device(params, device)
    pb = pb if pb.is_floating_point() else pb.float()
    single = pb.ndim == 1
    pb = pb[None, :] if single else pb
    d = order[1]
    e = sigma * torch.randn(pb.shape[0], n + d,
                            generator=as_generator(gen, pb.device),
                            device=pb.device, dtype=pb.dtype)
    y = _arma_filter(pb, e, order, include_intercept)
    for _ in range(d):
        y = torch.cumsum(y, dim=1)
    y = y[:, d:]
    return y[0] if single else y


def _arma_filter(pb, e, order: Order, include_intercept: bool):
    """``y_t = c + sum phi_i y_{t-i} + sum theta_j e_{t-j} + e_t`` from zero
    lags, for innovations ``e [B, n]``."""
    p, _, q = order
    c, phi, theta = _split_params(pb, order, include_intercept)
    b = e.shape[0]
    ydl = e.new_zeros(b, p)  # newest first
    el = e.new_zeros(b, q)
    out = []
    for t in range(e.shape[1]):
        yt = c + (phi * ydl).sum(-1) + (theta * el).sum(-1) + e[:, t]
        if p:
            ydl = torch.cat([yt[:, None], ydl[:, :-1]], dim=1)
        if q:
            el = torch.cat([e[:, t:t + 1], el[:, :-1]], dim=1)
        out.append(yt)
    return torch.stack(out, dim=1) if out else e.clone()


def _effects_args(params, y, device):
    yb, single = ensure_batched(to_device(y, device))
    pb = to_device(params, device, dtype=yb.dtype)
    pb = pb[None, :] if pb.ndim == 1 else pb
    return pb.expand(yb.shape[0], pb.shape[1]), yb, single


def remove_time_dependent_effects(params, y, order: Order,
                                  include_intercept: bool = True, *,
                                  device="cuda"):
    """Series -> innovations by the zero-padded-lag recursion (exactly
    inverted by :func:`add_time_dependent_effects`); the first ``d``
    entries carry the integration constants (the first value of each
    difference level).  One parameter row broadcasts over a panel."""
    pb, yb, single = _effects_args(params, y, device)
    d = order[1]
    inits, lv = [], yb
    for _ in range(d):
        inits.append(lv[:, :1])
        lv = lv[:, 1:] - lv[:, :-1]
    e = _css_errors(pb, lv, order, include_intercept, condition=False)
    out = torch.cat(inits + [e], dim=1)
    return out[0] if single else out


def add_time_dependent_effects(params, x, order: Order,
                               include_intercept: bool = True, *,
                               device="cuda"):
    """Inverse of :func:`remove_time_dependent_effects`: innovations (with
    the integration constants in the first ``d`` slots) -> the series."""
    pb, xb, single = _effects_args(params, x, device)
    d = order[1]
    y = _arma_filter(pb, xb[:, d:], order, include_intercept)
    for i in reversed(range(d)):  # integrate with the stored constants
        y = xb[:, i:i + 1] + torch.cumsum(y, dim=1)
        y = torch.cat([xb[:, i:i + 1], y], dim=1)
    return y[0] if single else y


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

"""Statistical hypothesis tests (port of ``stats/tests.py``).

Augmented Dickey-Fuller, Durbin-Watson, Breusch-Godfrey, Breusch-Pagan,
Ljung-Box and KPSS.  Each test takes one series ``[time]`` or, with the same
code, a panel ``[batch, time]`` (every row its own test), so the
``batch_*`` wrappers are the tests themselves over an explicit batch
dimension.  Auxiliary regressions are ridge-stabilized normal equations
built from masked inner products of ``[B, rows]`` columns (no ``[B, rows,
k]`` design is materialized); chi-square tail probabilities come from the
regularized upper incomplete gamma function.

Every test is NaN-aware as the reference's: a regression row (or
autocovariance pair) is dropped whenever one of its inputs is NaN, so
ragged rows (leading or trailing padding, interior gaps) run through the
same code with 0/1 row weights, and the degrees of freedom and the sample
size behind the p-value tables count valid observations only.  Unit-root
p-values interpolate the reference's finite-sample quantile tables
(``_tables.py``, a verbatim copy) linearly in the statistic and in 1/n.

Entry points take ``device`` (default ``"cuda"``) and move numpy or tensor
input there; results are tensors, 0-d for one series.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.base import to_device
from . import _tables

# ---------------------------------------------------------------------------
# Distribution helpers
# ---------------------------------------------------------------------------


def chi2_sf(x, df):
    """Chi-square survival function via the regularized upper gamma."""
    x = torch.as_tensor(x)
    return torch.special.gammaincc(torch.as_tensor(df / 2.0, dtype=x.dtype,
                                                   device=x.device), x / 2.0)


def _interp(x, xp, fp):
    """``jnp.interp`` row by row: ``x [B]``, ``xp [B, P]`` ascending,
    ``fp [P]``; constant beyond either end."""
    P = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp, x[:, None].contiguous(),
                                       right=True)[:, 0], 1, P - 1)
    x0 = xp.gather(1, (i - 1)[:, None])[:, 0]
    dx = xp.gather(1, i[:, None])[:, 0] - x0
    df = fp[i] - fp[i - 1]
    tiny = dx.abs() <= torch.finfo(xp.dtype).eps * torch.finfo(xp.dtype).eps
    f = torch.where(tiny, fp[i - 1],
                    fp[i - 1] + ((x - x0) / torch.where(tiny, 1.0, dx)) * df)
    f = torch.where(x < xp[:, 0], fp[0], f)
    return torch.where(x > xp[:, -1], fp[-1], f)


def _table_pvalue(stat, n_eff, table_rows, upper_tail: bool):
    """Finite-sample p-value: the quantile surface interpolated to
    ``n_eff`` on the 1/n scale, then piecewise-linearly in the statistic;
    saturates at the simulated probability range [0.01, 0.99]."""
    stat = torch.as_tensor(stat)
    shape = stat.shape
    stat = stat.reshape(-1)
    kw = dict(dtype=stat.dtype, device=stat.device)
    ns = torch.as_tensor(_tables.NS, **kw)
    probs = torch.as_tensor(_tables.PROBS, **kw)
    tab = torch.as_tensor(table_rows, **kw)  # [len(ns), len(probs)]
    # an ascending grid in u = 1/n: reverse the n axis
    xs = (1.0 / ns).flip(0)
    tabr = tab.flip(0)
    n_eff = torch.as_tensor(n_eff, **kw).reshape(-1).expand_as(stat)
    u = torch.clamp(1.0 / torch.clamp(n_eff, min=1.0), xs[0], xs[-1])
    i = torch.clamp(torch.searchsorted(xs, u.contiguous()), 1,
                    xs.shape[0] - 1)
    w = ((u - xs[i - 1]) / (xs[i] - xs[i - 1]))[:, None]
    row = (1.0 - w) * tabr[i - 1] + w * tabr[i]
    cum = _interp(stat, row, probs)
    return (1.0 - cum if upper_tail else cum).reshape(shape)


def _weighted_regression(cols, y, w):
    """0/1-row-weighted OLS of ``y [B, rows]`` on the columns ``cols``
    (each broadcastable to ``[B, rows]``) -> ``(beta [B, k], resid [B,
    rows], XtX_inv [B, k, k], n_rows [B])``.

    One ridge-stabilized Gram matrix serves the coefficients and the
    standard errors, so singular designs (constant series, every row
    dropped) stay finite."""
    k = len(cols)
    XtX = torch.stack([torch.stack([(w * ci * cj).sum(-1) for cj in cols],
                                   -1) for ci in cols], -2)
    Xty = torch.stack([(w * ci * y).sum(-1) for ci in cols], -1)
    trace = torch.diagonal(XtX, dim1=-2, dim2=-1).sum(-1)
    ridge = 1e-8 * torch.clamp(trace / k, min=1.0)
    eye = torch.eye(k, dtype=y.dtype, device=y.device)
    XtX_inv = torch.linalg.inv(XtX + ridge[:, None, None] * eye)
    beta = (XtX_inv @ Xty[..., None])[..., 0]
    fitted = sum(beta[:, j, None] * c for j, c in enumerate(cols))
    resid = (y - fitted) * w  # zero on dropped rows
    return beta, resid, XtX_inv, w.sum(-1)


def _panel(x, device):
    """``[time]`` or ``[batch, time]`` -> ``([B, time], single)``."""
    x = to_device(x, device)
    if x.ndim not in (1, 2):
        raise ValueError(f"series must be [time] or [batch, time], got "
                         f"{tuple(x.shape)}")
    return (x[None], True) if x.ndim == 1 else (x, False)


def _out(single, *xs):
    return tuple(x[0] for x in xs) if single else xs


# ---------------------------------------------------------------------------
# Augmented Dickey-Fuller
# ---------------------------------------------------------------------------


def adftest(y, max_lag: int = 1, regression: str = "c", *,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """ADF unit-root test -> (tau statistic, p-value).

    Regression: ``dy_t = [deterministics] + gamma y_{t-1} + sum_{i <=
    max_lag} delta_i dy_{t-i} + e_t``; ``tau = gamma_hat / se``.
    ``regression``: "nc" (none), "c" (constant), "ct" (constant + trend).
    NaN observations drop every regression row they touch.
    """
    if regression not in ("nc", "c", "ct"):
        raise ValueError(f"regression must be nc|c|ct, got {regression!r}")
    yb, single = _panel(y, device)
    vy = ~torch.isnan(yb)
    yz = torch.nan_to_num(yb)
    dy = yz[:, 1:] - yz[:, :-1]
    vdy = vy[:, 1:] & vy[:, :-1]
    m = dy.shape[1]
    target = dy[:, max_lag:]  # row r: target dy_{r + max_lag}
    rows = target.shape[1]
    w = vdy[:, max_lag:] & vy[:, max_lag:-1]
    cols = [yz[:, max_lag:-1]]  # y_{t-1}: gamma is coefficient 0
    for i in range(1, max_lag + 1):
        cols.append(dy[:, max_lag - i:m - i])
        w = w & vdy[:, max_lag - i:m - i]
    if regression in ("c", "ct"):
        cols.append(torch.ones_like(target))
    if regression == "ct":
        # a shift of the trend origin is absorbed by the intercept
        cols.append(torch.arange(rows, dtype=yb.dtype,
                                 device=yb.device).expand_as(target))
    beta, resid, XtX_inv, n_rows = _weighted_regression(
        cols, target, w.to(yb.dtype))
    dof = torch.clamp(n_rows - len(cols), min=1.0)
    sigma2 = (resid * resid).sum(-1) / dof
    tau = beta[:, 0] / torch.sqrt(sigma2 * XtX_inv[:, 0, 0])
    # the null table is simulated on the pure DF regression (n observations
    # give n-1 rows): mapping through the row count shrinks the effective
    # sample with the lag augmentation, as it shrinks the dof
    p = _table_pvalue(tau, n_rows + 1.0, _tables.DF_TAU[regression],
                      upper_tail=False)
    return _out(single, tau, p)


# ---------------------------------------------------------------------------
# Durbin-Watson
# ---------------------------------------------------------------------------


def dwtest(residuals, *, device="cuda") -> torch.Tensor:
    """Durbin-Watson statistic ``sum (e_t - e_{t-1})^2 / sum e_t^2`` in
    (0, 4); about 2 means no first-order serial correlation.  NaN residuals
    drop their pairs and terms."""
    e, single = _panel(residuals, device)
    v = ~torch.isnan(e)
    ez = torch.nan_to_num(e)
    pair = (v[:, 1:] & v[:, :-1]).to(e.dtype)
    num = (pair * (ez[:, 1:] - ez[:, :-1]) ** 2).sum(-1)
    den = torch.where(v, ez * ez, 0.0).sum(-1)
    return _out(single, num / den)[0]


# ---------------------------------------------------------------------------
# Breusch-Godfrey and Breusch-Pagan
# ---------------------------------------------------------------------------


def _factors(factors, e, device):
    """Factors as ``[B, time, k]`` for residuals ``e [B, time]``: one
    series' ``[time]`` / ``[time, k]``, shared by every row, or per row
    ``[B, time, k]``."""
    X = to_device(factors, device, dtype=e.dtype)
    if X.ndim == 1:
        X = X[:, None]
    if X.ndim == 2:
        X = X[None].expand(e.shape[0], *X.shape)
    return X


def _lm_stat(cols, target, w):
    """``(n R^2, n_rows)`` of a 0/1-weighted auxiliary regression."""
    _, resid, _, n_rows = _weighted_regression(cols, target, w)
    tmean = (target * w).sum(-1) / torch.clamp(n_rows, min=1.0)
    tss = (w * (target - tmean[:, None]) ** 2).sum(-1)
    r2 = 1.0 - (resid * resid).sum(-1) / torch.clamp(tss, min=1e-30)
    return n_rows * r2


def _bg(e, X, max_lag: int):
    n = e.shape[1]
    ve = ~torch.isnan(e)
    vX = ~torch.isnan(X).any(-1)
    ez = torch.nan_to_num(e)
    Xz = torch.nan_to_num(X)
    w = ve[:, max_lag:] & vX[:, max_lag:]
    for i in range(1, max_lag + 1):
        w = w & ve[:, max_lag - i:n - i]
    target = ez[:, max_lag:]
    cols = [torch.ones_like(target)]
    cols += [Xz[:, max_lag:, j] for j in range(X.shape[-1])]
    cols += [ez[:, max_lag - i:n - i] for i in range(1, max_lag + 1)]
    stat = _lm_stat(cols, target, w.to(e.dtype))
    return stat, chi2_sf(stat, float(max_lag))


def bgtest(residuals, factors, max_lag: int = 1, *,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Breusch-Godfrey serial-correlation LM test -> (n R^2, p-value).

    Auxiliary regression of ``e_t`` on ``[1, factors_t, e_{t-1} ..
    e_{t-max_lag}]``; the statistic is chi2(max_lag) under H0.  Rows
    touching a NaN residual or factor are dropped.
    """
    e, single = _panel(residuals, device)
    return _out(single, *_bg(e, _factors(factors, e, device), max_lag))


def _bp(e, X):
    w = ~torch.isnan(e) & ~torch.isnan(X).any(-1)
    ez = torch.nan_to_num(e)
    Xz = torch.nan_to_num(X)
    target = ez * ez
    cols = [torch.ones_like(target)]
    cols += [Xz[..., j] for j in range(X.shape[-1])]
    stat = _lm_stat(cols, target, w.to(e.dtype))
    return stat, chi2_sf(stat, float(X.shape[-1]))


def bptest(residuals, factors, *,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Breusch-Pagan heteroskedasticity LM test -> (n R^2, p-value).

    Auxiliary regression of ``e_t^2`` on ``[1, factors_t]``; chi2(k) under
    H0.  Rows with a NaN residual or factor are dropped.
    """
    e, single = _panel(residuals, device)
    return _out(single, *_bp(e, _factors(factors, e, device)))


# ---------------------------------------------------------------------------
# Ljung-Box
# ---------------------------------------------------------------------------


def lbtest(residuals, max_lag: int = 10, *,
           device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Ljung-Box white-noise test -> (Q, p-value), Q ~ chi2(max_lag).

    NaN residuals drop their autocovariance pairs; the Q scaling uses the
    valid-observation count.
    """
    e, single = _panel(residuals, device)
    n = e.shape[1]
    v = ~torch.isnan(e)
    nv = v.to(e.dtype).sum(-1)
    ez = torch.nan_to_num(e)
    mean = torch.where(v, ez, 0.0).sum(-1) / torch.clamp(nv, min=1.0)
    d = torch.where(v, ez - mean[:, None], 0.0)
    denom = (d * d).sum(-1)
    q = sum(((d[:, k:] * d[:, :n - k]).sum(-1) / denom) ** 2
            / torch.clamp(nv - k, min=1.0) for k in range(1, max_lag + 1))
    q = nv * (nv + 2.0) * q
    return _out(single, q, chi2_sf(q, float(max_lag)))


# ---------------------------------------------------------------------------
# KPSS
# ---------------------------------------------------------------------------


def kpsstest(y, regression: str = "c", lags: int | None = None, *,
             device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """KPSS stationarity test -> (eta, p-value); H0 is (trend-)
    stationarity, the reverse of ADF's.

    The long-run variance uses a Bartlett window with the KPSS paper's l12
    bandwidth ``trunc(12 (n/100)^0.25)`` from the valid observation count
    (the loop runs to the bandwidth of the full length; terms past a row's
    own bandwidth get zero weight), as the finite-sample null table was
    simulated.  ``lags`` overrides the bandwidth for the statistic (the
    p-value then assumes l12 all the same).  NaN observations are dropped
    from the demeaning or detrending and the partial sums hold through
    them.
    """
    if regression not in ("c", "ct"):
        raise ValueError(f"regression must be c|ct, got {regression!r}")
    yb, single = _panel(y, device)
    n = yb.shape[1]
    v = ~torch.isnan(yb)
    wf = v.to(yb.dtype)
    nv = wf.sum(-1)
    if lags is None:
        loop_lags = np_trunc_bandwidth(n)  # nv <= n
        l_dyn = torch.floor(12.0 * (nv / 100.0) ** 0.25)
    else:
        loop_lags = int(lags)
        l_dyn = torch.full_like(nv, float(lags))
    yz = torch.nan_to_num(yb)
    if regression == "c":
        mean = (yz * wf).sum(-1) / torch.clamp(nv, min=1.0)
        e = torch.where(v, yz - mean[:, None], 0.0)
    else:
        t = torch.arange(n, dtype=yb.dtype, device=yb.device).expand_as(yz)
        _, e, _, _ = _weighted_regression([torch.ones_like(yz), t], yz, wf)
    s = torch.cumsum(e, dim=-1)
    lrv = (e * e).sum(-1) / nv
    for k in range(1, loop_lags + 1):
        w = torch.clamp(1.0 - k / (l_dyn + 1.0), min=0.0)
        lrv = lrv + 2.0 * w * (e[:, k:] * e[:, :n - k]).sum(-1) / nv
    eta = torch.where(v, s * s, 0.0).sum(-1) / (
        nv * nv * torch.clamp(lrv, min=1e-30))
    p = _table_pvalue(eta, nv, _tables.KPSS_ETA[regression], upper_tail=True)
    return _out(single, eta, p)


def np_trunc_bandwidth(n: int) -> int:
    return int(12 * (n / 100.0) ** 0.25)


# ---------------------------------------------------------------------------
# Batched variants: one call over a whole panel [keys, time]
# ---------------------------------------------------------------------------


def _rows(panel, device):
    x = to_device(panel, device)
    if x.ndim != 2:
        raise ValueError(f"panel must be [keys, time], got {tuple(x.shape)}")
    return x


def batch_adftest(panel, max_lag: int = 1, regression: str = "c", *,
                  device="cuda"):
    return adftest(_rows(panel, device), max_lag, regression, device=device)


def batch_dwtest(panel, *, device="cuda"):
    return dwtest(_rows(panel, device), device=device)


def batch_lbtest(panel, max_lag: int = 10, *, device="cuda"):
    return lbtest(_rows(panel, device), max_lag, device=device)


def batch_kpsstest(panel, regression: str = "c", lags: int | None = None, *,
                   device="cuda"):
    # lags=None resolves per row to the valid-count bandwidth, so ragged
    # rows get the statistic they would get one by one
    return kpsstest(_rows(panel, device), regression, lags, device=device)


def batch_bgtest(resid_panel, factors, max_lag: int = 1, *, device="cuda"):
    """:func:`bgtest` over a panel: residuals ``[keys, time]``, factors
    shared ``[time, k]`` or per series ``[keys, time, k]``."""
    e = _rows(resid_panel, device)
    return _bg(e, _factors(factors, e, device), max_lag)


def batch_bptest(resid_panel, factors, *, device="cuda"):
    """:func:`bptest` over a panel: residuals ``[keys, time]``, factors
    shared ``[time, k]`` or per series ``[keys, time, k]``."""
    e = _rows(resid_panel, device)
    return _bp(e, _factors(factors, e, device))

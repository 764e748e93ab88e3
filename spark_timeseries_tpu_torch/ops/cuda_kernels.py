"""Hand-written CUDA kernels for the ARIMA fit path, with their wrappers.

Port of ``spark_timeseries_tpu/ops/pallas_kernels.py`` (the CSS and
Hannan-Rissanen parts).  Three kernels, sources in ``csrc/``:

==============  ==============  =============================================
wrapper         source          replaces (pallas_kernels.py)
==============  ==============  =============================================
``css_fwd``     ``css.cu``      ``_css_fwd_kernel`` via ``_css_fwd_call_f``
``css_bwd``     ``css.cu``      ``_css_bwd_kernel`` via ``_css_errors_bwd_f``
``hr_moments``  ``hr.cu``       ``_hr_kernel`` via ``_hr_moments``
==============  ==============  =============================================

Each wrapper checks device, dtype (float32), shape and contiguity and raises
on anything else; it launches its kernel for CUDA tensors (counting the
launch in :data:`LAUNCHES`) and runs the kernel's plain PyTorch version
(``*_plain``: a Python loop over time on ``[B]`` slices, in the kernel's
summation order) only for CPU tensors.  No path catches a failed build or
launch.  Panels are time-major ``[T, B]`` (``ops.layout``).

Above the wrappers sit the reference's entry points (``css_neg_loglik``,
``css_neg_loglik_folded``, ``css_errors``, ``css_last_errors``, ``hr_init``)
with its signatures, minus ``interpret``.  The CSS objective is a
``torch.autograd.Function`` whose backward is the adjoint kernel.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .layout import css_prefold, time_major

__all__ = [
    "LAUNCHES", "reset_launch_counts", "supported", "css_structural_ok",
    "hr_structural_ok", "css_fwd", "css_fwd_plain", "css_bwd",
    "css_bwd_plain", "hr_moments", "hr_moments_plain", "css_errors",
    "css_last_errors", "css_neg_loglik", "css_neg_loglik_folded", "hr_init",
    "css_prefold",
]

# kernel launches by wrapper name (plain-version calls are not counted)
LAUNCHES = {"css_fwd": 0, "css_bwd": 0, "hr_moments": 0}

_MODES = {"e": 0, "sum": 1, "both": 2, "tail": 3}
_MAX_CSS_LAG = 512


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def supported(x: torch.Tensor) -> bool:
    """True when the kernels can run on ``x``: float32 on a CUDA device."""
    return x.is_cuda and x.dtype == torch.float32


def css_structural_ok(p: int, q: int) -> bool:
    """Orders the CSS kernels take: rings of up to 512 lags (the
    reference's bound, ``pallas_kernels.css_structural_ok``)."""
    return 0 <= p <= _MAX_CSS_LAG and 0 <= q <= _MAX_CSS_LAG


def hr_structural_ok(p: int, q: int) -> bool:
    """Orders the moment kernel takes: p, q <= 8 (at most 32 columns)."""
    return 0 <= p <= 8 and 0 <= q <= 8


# ---------------------------------------------------------------------------
# argument checks and launch plumbing
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, shape, device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(device: torch.device) -> bool:
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(lib_name: str, fn: str, counter: str, device, *args) -> None:
    lib = _build.load(lib_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed with CUDA error {rc}")
    LAUNCHES[counter] += 1


def _t_limit(t_limit, T: int) -> int:
    t_limit = T if t_limit is None else int(t_limit)
    if not 0 <= t_limit <= T:
        raise ValueError(f"t_limit {t_limit} outside [0, {T}]")
    return t_limit


# ---------------------------------------------------------------------------
# CSS forward: e_t = m_t (y_t - c - sum phi_i y_{t-i} - sum theta_j e_{t-j})
# ---------------------------------------------------------------------------


def css_fwd(yt, params, zb, p: int, q: int, mode: str, t_limit=None):
    """CSS errors of ``[T, B]`` panel ``yt`` under ``params [B, 1+p+q]``
    (``[c, phi, theta]``) with the live mask ``zb <= t < t_limit``.

    ``mode``: ``"e"`` -> errors ``[T, B]``; ``"sum"`` -> per-series SSE
    ``[B]``; ``"both"`` -> ``(e, sse)`` with the SSE bitwise equal to
    ``"sum"``; ``"tail"`` -> the last ``q`` errors before ``t_limit``,
    ``[B, q]`` oldest first.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown css_fwd mode {mode!r}")
    if not css_structural_ok(p, q):
        raise ValueError(f"CSS kernel supports p, q <= {_MAX_CSS_LAG} "
                         f"(got p={p}, q={q})")
    T, B = yt.shape
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("params", params, (B, 1 + p + q), dev)
    _check("zb", zb, (B,), dev)
    t_limit = _t_limit(t_limit, T)
    if mode == "tail" and t_limit < q:
        raise ValueError(f"t_limit {t_limit} < q={q}")
    if not _on_cuda(dev):
        return css_fwd_plain(yt, params, zb, p, q, mode, t_limit)
    e = torch.empty_like(yt) if mode in ("e", "both") else None
    sse = yt.new_empty(B) if mode in ("sum", "both") else None
    tail = yt.new_empty(q, B) if mode == "tail" else None
    if B:
        par_t = params.t().contiguous()
        _launch("css", "sts_css_fwd", "css_fwd", dev, _ptr(yt), _ptr(par_t),
                _ptr(zb), _ptr(e), _ptr(sse), _ptr(tail), B, T, p, q,
                t_limit, _MODES[mode])
    return _fwd_out(mode, e, sse, None if tail is None else tail.t())


def _fwd_out(mode, e, sse, tail):
    return {"e": e, "sum": sse, "both": (e, sse), "tail": tail}[mode]


def css_fwd_plain(yt, params, zb, p: int, q: int, mode: str, t_limit=None):
    """Plain PyTorch version of :func:`css_fwd` (same arguments, same
    per-step arithmetic and summation order)."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    c = params[:, 0]
    phi = params[:, 1:1 + p]
    th = params[:, 1 + p:1 + p + q]
    zero = yt.new_zeros(B)
    yl = [zero] * p  # yl[i] = y_{t-1-i}
    el = [zero] * q  # el[j] = e_{t-1-j}
    acc = zero
    es = []
    for t in range(t_limit if mode == "tail" else T):
        yv = yt[t]
        pred = c
        for i in range(p):
            pred = pred + phi[:, i] * yl[i]
        for j in range(q):
            pred = pred + th[:, j] * el[j]
        live = (zb <= t) & (t < t_limit)
        et = torch.where(live, yv - pred, 0.0)
        if mode in ("e", "both"):
            es.append(et)
        acc = acc + et * et
        if p:
            yl = [yv] + yl[:p - 1]
        if q:
            el = [et] + el[:q - 1]
    e = torch.stack(es) if mode in ("e", "both") else None
    tail = (torch.stack(el[::-1], dim=1) if q else yt.new_zeros(B, 0)) \
        if mode == "tail" else None
    return _fwd_out(mode, e, acc, tail)


# ---------------------------------------------------------------------------
# CSS adjoint: a_t = m_t (g_t - sum theta_j a_{t+j})
# ---------------------------------------------------------------------------


def css_bwd(yt, et, params, zb, g, p: int, q: int, want_gy: bool = False,
            t_limit=None):
    """Gradients of the CSS errors' cotangent ``g`` -> ``(gparams [B, k],
    gy [T, B] or None)``.

    ``g`` is either the errors' cotangent ``[T, B]`` or, for the objective
    ``sum_t e_t^2``, its per-series cotangent ``[B]`` (``g_t = 2 e_t g`` is
    formed in the kernel).  ``gy`` (the data cotangent) is computed only
    with ``want_gy``.
    """
    if not css_structural_ok(p, q):
        raise ValueError(f"CSS kernel supports p, q <= {_MAX_CSS_LAG} "
                         f"(got p={p}, q={q})")
    T, B = yt.shape
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("et", et, (T, B), dev)
    _check("params", params, (B, 1 + p + q), dev)
    _check("zb", zb, (B,), dev)
    g_is_sse = g.dim() == 1
    _check("g", g, (B,) if g_is_sse else (T, B), dev)
    t_limit = _t_limit(t_limit, T)
    if not _on_cuda(dev):
        return css_bwd_plain(yt, et, params, zb, g, p, q, want_gy, t_limit)
    gpar = yt.new_empty(1 + p + q, B)
    gy = torch.empty_like(yt) if want_gy else None
    if B:
        par_t = params.t().contiguous()
        _launch("css", "sts_css_bwd", "css_bwd", dev, _ptr(yt), _ptr(et),
                _ptr(par_t), _ptr(zb), _ptr(g), _ptr(gpar), _ptr(gy), B, T,
                p, q, t_limit, int(g_is_sse))
    return gpar.t(), gy


def css_bwd_plain(yt, et, params, zb, g, p: int, q: int,
                  want_gy: bool = False, t_limit=None):
    """Plain PyTorch version of :func:`css_bwd` (the kernel's order: t
    descending, lags nearest first)."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    g_is_sse = g.dim() == 1
    phi = params[:, 1:1 + p]
    th = params[:, 1 + p:1 + p + q]
    zero = yt.new_zeros(B)
    ac = max(p, q)
    al = [zero] * ac  # al[i] = a_{t+1+i}
    gc, gphi, gth = zero, [zero] * p, [zero] * q
    gys = [None] * T
    for t in reversed(range(T)):
        gt = 2.0 * et[t] * g if g_is_sse else g[t]
        av = gt
        for j in range(q):
            av = av - th[:, j] * al[j]
        live = (zb <= t) & (t < t_limit)
        a = torch.where(live, av, 0.0)
        if want_gy:
            d = a
            for i in range(p):
                d = d - phi[:, i] * al[i]
            gys[t] = d
        gc = gc - a
        for i in range(p):
            if t - 1 - i >= 0:
                gphi[i] = gphi[i] - yt[t - 1 - i] * a
        for j in range(q):
            if t - 1 - j >= 0:
                gth[j] = gth[j] - et[t - 1 - j] * a
        if ac:
            al = [a] + al[:ac - 1]
    gparams = torch.stack([gc, *gphi, *gth], dim=1)
    return gparams, (torch.stack(gys) if want_gy else None)


# ---------------------------------------------------------------------------
# Hannan-Rissanen moment sweep
# ---------------------------------------------------------------------------


def _tri(n: int, a: int, c: int) -> int:
    return a * n - a * (a - 1) // 2 + (c - a)


def _hr_ncols(lag_y, lag_e, intercept):
    ncols = int(intercept) + lag_y + lag_e
    return ncols, ncols * (ncols + 1) // 2 + ncols


def hr_moments(yt, zb, lag_y: int, lag_e: int, intercept: bool, woff: int,
               beta_m: int = 0, beta=None, t_limit=None):
    """Weighted lagged moment sums ``[B, nacc]`` of the ``[T, B]`` panel.

    Columns at step t: ``[1 (intercept), y_{t-1}..y_{t-lag_y},
    eh_{t-1}..eh_{t-lag_e}]`` with weight ``[zb + woff <= t < t_limit]``;
    the output holds ``sum w c_a c_b`` (a <= b, upper triangle row by row)
    then ``sum w c_a y_t``.  With ``lag_e > 0`` the residual ``eh`` of the
    AR(``beta_m``) fit ``beta [B, beta_m + 1]`` is rebuilt on the fly.
    """
    T, B = yt.shape
    dev = yt.device
    ncols, nacc = _hr_ncols(lag_y, lag_e, intercept)
    if not 1 <= ncols <= 32:
        raise ValueError(f"moment kernel takes 1..32 columns, got {ncols}")
    if lag_e and not 0 <= beta_m <= ncols + 1:
        raise ValueError(f"beta_m {beta_m} outside [0, {ncols + 1}]")
    _check("yt", yt, (T, B), dev)
    _check("zb", zb, (B,), dev)
    if lag_e:
        _check("beta", beta, (B, beta_m + 1), dev)
    t_limit = _t_limit(t_limit, T)
    if not _on_cuda(dev):
        return hr_moments_plain(yt, zb, lag_y, lag_e, intercept, woff,
                                beta_m, beta, t_limit)
    acc = yt.new_empty(nacc, B)
    if B:
        beta_t = beta.t().contiguous() if lag_e else None
        _launch("hr", "sts_hr_moments", "hr_moments", dev, _ptr(yt),
                _ptr(zb), _ptr(beta_t), _ptr(acc), B, T, lag_y, lag_e,
                int(intercept), woff, beta_m if lag_e else 0, t_limit)
    return acc.t()


def hr_moments_plain(yt, zb, lag_y: int, lag_e: int, intercept: bool,
                     woff: int, beta_m: int = 0, beta=None, t_limit=None):
    """Plain PyTorch version of :func:`hr_moments`."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    ncols, nacc = _hr_ncols(lag_y, lag_e, intercept)
    npair = nacc - ncols
    ic = int(intercept)
    zero = yt.new_zeros(B)
    col = [yt.new_ones(B)] * ic + [zero] * (lag_y + lag_e)
    yr = [zero] * beta_m  # yr[i] = y_{t-1-i}
    s = [zero] * nacc
    zw = zb + woff
    z1 = zb + beta_m
    for t in range(min(t_limit, T)):
        yv = yt[t]
        w = (zw <= t).to(yt.dtype)
        for a in range(ncols):
            wa = w * col[a]
            for c in range(a, ncols):
                s[_tri(ncols, a, c)] = s[_tri(ncols, a, c)] + wa * col[c]
            s[npair + a] = s[npair + a] + wa * yv
        if lag_e:
            pred = beta[:, 0]
            for i in range(beta_m):
                pred = pred + beta[:, i + 1] * yr[i]
            eh = (z1 <= t).to(yt.dtype) * (yv - pred)
            ecols = [eh] + col[ic + lag_y:ic + lag_y + lag_e - 1]
        else:
            ecols = []
        ycols = [yv] + col[ic:ic + lag_y - 1] if lag_y else []
        col = col[:ic] + ycols + ecols
        if beta_m:
            yr = [yv] + yr[:beta_m - 1]
    return torch.stack(s, dim=1)


# ---------------------------------------------------------------------------
# entry points (the reference's signatures, without ``interpret``)
# ---------------------------------------------------------------------------


class _CssSSE(torch.autograd.Function):
    """Per-series CSS sum of squares ``[B]`` of the time-major panel.

    Forward runs ``both`` (saving the errors) when a gradient is wanted and
    ``sum`` otherwise; the two SSEs are bitwise equal.  Backward is the
    adjoint kernel fed the per-series cotangent directly; the data
    cotangent is computed only when the data requires a gradient."""

    @staticmethod
    def forward(ctx, params, yt, zb, p, q, t_limit, save):
        ctx.pq = (p, q, t_limit)
        if not save:
            return css_fwd(yt, params, zb, p, q, "sum", t_limit)
        e, sse = css_fwd(yt, params, zb, p, q, "both", t_limit)
        ctx.save_for_backward(params, yt, zb, e)
        return sse

    @staticmethod
    def backward(ctx, gbar):
        params, yt, zb, e = ctx.saved_tensors
        p, q, t_limit = ctx.pq
        want_gy = ctx.needs_input_grad[1]
        gpar, gy = css_bwd(yt, e, params, zb, gbar.contiguous(), p, q,
                           want_gy, t_limit)
        return (gpar if ctx.needs_input_grad[0] else None, gy,
                None, None, None, None, None)


class _CssErrors(torch.autograd.Function):
    """CSS errors ``[T, B]`` of the time-major panel, differentiable in the
    parameters and the data through the adjoint kernel."""

    @staticmethod
    def forward(ctx, params, yt, zb, p, q):
        ctx.pq = (p, q)
        e = css_fwd(yt, params, zb, p, q, "e")
        ctx.save_for_backward(params, yt, zb, e)
        return e

    @staticmethod
    def backward(ctx, g):
        params, yt, zb, e = ctx.saved_tensors
        p, q = ctx.pq
        gpar, gy = css_bwd(yt, e, params, zb, g.contiguous(), p, q,
                           ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gy, None, None,
                None)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def css_errors(p: int, q: int, params, yd, zb):
    """Batched ARMA(p, q) CSS errors ``[B, T]`` (natural layout).

    ``params [B, 1+p+q]`` rows ``[c, phi, theta]`` (pass ``c = 0`` without
    an intercept); ``yd [B, T]`` with any invalid prefix already zeroed;
    ``zb [B]`` float: errors before it are zero.  Differentiable in
    ``params`` and ``yd``."""
    return _CssErrors.apply(params, time_major(yd), zb, p, q).t()


def css_last_errors(p: int, q: int, params, yd, zb):
    """The last ``q`` CSS errors ``[B, q]`` (oldest first): the forecast's
    carry, from a read-only pass that writes O(B q).  Not differentiable."""
    if q == 0:
        return yd.new_zeros(yd.shape[0], 0)
    if yd.shape[1] < q:
        raise ValueError(f"series length {yd.shape[1]} < q={q}")
    return css_fwd(time_major(yd), params, zb, p, q, "tail")


def kernel_params(params, include_intercept: bool):
    if include_intercept:
        return params
    # the kernel layout always carries an intercept slot
    return torch.cat([params.new_zeros(params.shape[0], 1), params], dim=1)


def css_neg_loglik_folded(params, yt, zb, n: int, order,
                          include_intercept: bool, n_valid=None):
    """Batched CSS negative log-likelihood ``[B]`` from a panel already in
    the kernels' layout (:func:`css_prefold`); matches
    :func:`css_neg_loglik` exactly.  Differentiable in ``params`` (and in
    ``yt``) through the adjoint kernel."""
    p, _, q = order
    b = params.shape[0]
    nv = (torch.full((b,), n, dtype=params.dtype, device=params.device)
          if n_valid is None else n_valid.to(params.dtype))
    pk = kernel_params(params, include_intercept).contiguous()
    css = _CssSSE.apply(pk, yt, zb, p, q, n, _needs_grad(pk, yt))
    n_eff = nv - p
    sigma2 = css / n_eff
    return 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)


def css_neg_loglik(params, yd, order, include_intercept: bool,
                   n_valid=None):
    """Batched CSS negative log-likelihood ``[B]`` of the ``[B, T]`` panel
    ``yd`` (matches ``models.arima.css_neg_loglik`` row by row)."""
    yt, zb = css_prefold(yd, order, n_valid)
    return css_neg_loglik_folded(params, yt, zb, yd.shape[1], order,
                                 include_intercept, n_valid)


def _solve_moments(acc, ncols: int, ridge: float = 1e-8):
    """``[B, nacc]`` moment rows -> ridge-stabilized OLS solutions."""
    from ..utils.linalg import ridge_solve

    b = acc.shape[0]
    XtX = acc.new_empty(b, ncols, ncols)
    r = 0
    for a in range(ncols):
        for c in range(a, ncols):
            XtX[:, a, c] = acc[:, r]
            XtX[:, c, a] = acc[:, r]
            r += 1
    return ridge_solve(XtX, acc[:, r:r + ncols], ridge)


def hr_init(yd, order, include_intercept: bool, n_valid=None, *, yt=None):
    """Batched Hannan-Rissanen initial values ``[B, k]`` from two moment
    sweeps (stage-1 AR(m) -> solve -> stage 2 with residuals rebuilt on the
    fly -> solve); the same weighted normal equations as
    ``models.arima.hannan_rissanen_batched``.

    ``yd``: differenced ``[B, T]`` panel with the invalid prefix zeroed;
    ``yt``: optionally that panel already time-major (:func:`css_prefold`),
    so a fit converts its panel once.
    """
    p, _, q = order
    if not hr_structural_ok(p, q):
        raise ValueError(f"HR moment kernel supports p, q <= 8 (got {p}, {q})")
    b, t = yd.shape
    m = min(p + q + 1, max(t // 4, 1))
    nv = (torch.full((b,), t, dtype=torch.int32, device=yd.device)
          if n_valid is None else n_valid)
    zb = (t - nv).to(yd.dtype)
    if yt is None:
        yt = time_major(yd)
    acc1 = hr_moments(yt, zb, m, 0, True, m)
    beta1 = _solve_moments(acc1, m + 1)
    ncols2 = int(include_intercept) + p + q
    if ncols2 == 0:
        return yd.new_zeros(b, 0)
    acc2 = hr_moments(yt, zb, p, q, include_intercept, m + q, m,
                      beta1.contiguous())
    return _solve_moments(acc2, ncols2)

"""Hand-written CUDA kernels of the port, with their wrappers.

Port of ``spark_timeseries_tpu/ops/pallas_kernels.py``.  Seven kernels,
sources in ``csrc/``:

==============  ===============  ==============================================
wrapper         source           replaces (pallas_kernels.py)
==============  ===============  ==============================================
``css_fwd``     ``css.cu``       ``_css_fwd_kernel`` via ``_css_fwd_call_f``
``css_bwd``     ``css.cu``       ``_css_bwd_kernel`` via ``_css_errors_bwd_f``
``hr_moments``  ``hr.cu``        ``_hr_kernel`` via ``_hr_moments``
``fill_chain``  ``fill.cu``      ``_fillchain_fused_kernel`` via
                                 ``_fill_linear_call_folded``
``autocorr``    ``autocorr.cu``  ``_autocorr_kernel`` via
                                 ``_batch_autocorr_call``
``garch_fwd``   ``garch.cu``     ``_garch_fwd_kernel`` via ``_garch_fwd_call``
``garch_bwd``   ``garch.cu``     ``_garch_bwd_kernel`` via ``_garch_h_bwd``
==============  ===============  ==============================================

Each wrapper checks device, dtype (float32), shape and contiguity and raises
on anything else; it launches its kernel for CUDA tensors (counting the
launch in :data:`LAUNCHES`) and runs the kernel's plain PyTorch version
(``*_plain``: a Python loop over time on ``[B]`` slices, in the kernel's
summation order) only for CPU tensors.  No path catches a failed build or
launch.  Panels are time-major ``[T, B]`` (``ops.layout``).

Above the wrappers sit the reference's entry points with its signatures,
minus ``interpret``: ``css_neg_loglik``, ``css_neg_loglik_folded``,
``css_errors``, ``css_last_errors``, ``hr_init``; ``fill_linear_chain``,
``fill_linear``, ``fill_linear_chain_folded``; ``batch_autocorr``,
``batch_autocorr_folded``; ``garch_variances``, ``garch_neg_loglik``.  The
CSS and GARCH objectives are ``torch.autograd.Function``s whose backward is
the adjoint kernel.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .layout import FoldedPanel, css_prefold, time_major

__all__ = [
    "LAUNCHES", "reset_launch_counts", "supported", "css_structural_ok",
    "hr_structural_ok", "css_fwd", "css_fwd_plain", "css_bwd",
    "css_bwd_plain", "hr_moments", "hr_moments_plain", "css_errors",
    "css_last_errors", "css_neg_loglik", "css_neg_loglik_folded", "hr_init",
    "css_prefold", "autocorr_structural_ok", "fill_chain",
    "fill_chain_plain", "autocorr", "autocorr_plain", "garch_fwd",
    "garch_fwd_plain", "garch_bwd", "garch_bwd_plain", "fill_linear_chain",
    "fill_linear", "fill_linear_chain_folded", "batch_autocorr",
    "batch_autocorr_folded", "garch_variances", "garch_neg_loglik",
    "garch_h0_folded", "garch_neg_loglik_folded", "garch_prefold",
    "CHAIN_OUTPUTS",
]

# kernel launches by wrapper name (plain-version calls are not counted)
LAUNCHES = {"css_fwd": 0, "css_bwd": 0, "hr_moments": 0, "fill_chain": 0,
            "autocorr": 0, "garch_fwd": 0, "garch_bwd": 0}

_MODES = {"e": 0, "sum": 1, "both": 2, "tail": 3}
_MAX_CSS_LAG = 512
_MAX_ACF_LAG = 1024


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


def autocorr_structural_ok(num_lags: int, n_time: int) -> bool:
    """Lag counts the autocorrelation kernel takes: ``0 < num_lags <
    min(T, 1024)`` (the reference's bound)."""
    return 0 < num_lags < min(n_time, _MAX_ACF_LAG)


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
# fill-linear chain: (filled, lag-1 difference, lag-1 shift)
# ---------------------------------------------------------------------------

CHAIN_OUTPUTS = ("filled", "diff", "lag")


def _panel_shape(name: str, x) -> tuple:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a [T, B] tensor")
    return tuple(x.shape)


def fill_chain(yt, which=(True, True, True)):
    """Linear fill of the interior NaN gaps of the ``[T, B]`` panel ``yt``,
    with its lag-1 difference and lag-1 shift -> the ``[T, B]`` outputs that
    ``which`` (flags for ``(filled, diff, lag)``) asks for, in that order.

    Leading and trailing NaN runs stay NaN; the difference and the shift
    are NaN at t = 0, and a NaN fill at t-1 makes the difference NaN.
    """
    which = tuple(bool(w) for w in which)
    if len(which) != 3 or not any(which):
        raise ValueError(f"which must flag 1-3 of {CHAIN_OUTPUTS}, got "
                         f"{which!r}")
    T, B = _panel_shape("yt", yt)
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    if not _on_cuda(dev):
        return fill_chain_plain(yt, which)
    outs = [torch.empty_like(yt) if w else None for w in which]
    if B and T:
        _launch("fill", "sts_fill_chain", "fill_chain", dev, _ptr(yt),
                *(_ptr(o) for o in outs), B, T)
    return tuple(o for o in outs if o is not None)


def fill_chain_plain(yt, which=(True, True, True)):
    """Plain PyTorch version of :func:`fill_chain`: a backward sweep for the
    next valid (value, index), then the forward fill with the kernel's
    arithmetic (the kernel finds the next valid value when it closes a
    gap; the values are the same)."""
    T, B = yt.shape
    nan = yt.new_full((B,), float("nan"))
    nxt = [None] * T  # (next valid value, its index) at or after t
    nv, ni = yt.new_zeros(B), yt.new_full((B,), 1e30)
    for t in reversed(range(T)):
        valid = ~torch.isnan(yt[t])
        nv = torch.where(valid, yt[t], nv)
        ni = torch.where(valid, float(t), ni)
        nxt[t] = (nv, ni)
    pv, pi, fprev = yt.new_zeros(B), yt.new_full((B,), -1e30), nan
    outs = ([], [], [])
    for t in range(T):
        yv = yt[t]
        valid = ~torch.isnan(yv)
        nv, ni = nxt[t]
        interior = (pi >= 0.0) & (ni < 1e30)
        w = (t - pi) / torch.clamp(ni - pi, min=1.0)
        interp = pv * (1.0 - w) + nv * w
        fill = torch.where(valid, yv, torch.where(interior, interp, nan))
        for out, v in zip(outs, (fill, fill - fprev, fprev)):
            out.append(v)
        pv = torch.where(valid, yv, pv)
        pi = torch.where(valid, float(t), pi)
        fprev = fill
    return tuple((torch.stack(o) if T else yt.new_empty(0, B))
                 for o, w in zip(outs, which) if w)


# ---------------------------------------------------------------------------
# multi-lag autocorrelation with the valid-sample mean
# ---------------------------------------------------------------------------


def autocorr(yt, num_lags: int):
    """Sample autocorrelation at lags ``1..num_lags`` of each series of the
    ``[T, B]`` panel -> ``[B, num_lags]`` (valid-sample mean and
    denominator; a constant or all-NaN series gives NaN)."""
    T, B = _panel_shape("yt", yt)
    if not autocorr_structural_ok(num_lags, T):
        raise ValueError(f"num_lags must be in (0, min(T, {_MAX_ACF_LAG})) "
                         f"= (0, {min(T, _MAX_ACF_LAG)}), got {num_lags}")
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    if not _on_cuda(dev):
        return autocorr_plain(yt, num_lags)
    out = yt.new_empty(num_lags, B)
    if B:
        _launch("autocorr", "sts_autocorr", "autocorr", dev, _ptr(yt),
                _ptr(out), B, T, num_lags)
    return out.t()


def autocorr_plain(yt, num_lags: int):
    """Plain PyTorch version of :func:`autocorr` (the kernel's two passes
    and summation order)."""
    T, B = yt.shape
    zero = yt.new_zeros(B)
    n, s = zero, zero
    for t in range(T):
        valid = ~torch.isnan(yt[t])
        n = n + valid.to(yt.dtype)
        s = s + torch.where(valid, yt[t], 0.0)
    mean = s / torch.clamp(n, min=1.0)
    dl = [zero] * num_lags  # dl[k] = d_{t-1-k}
    acc = [zero] * num_lags
    a0 = zero
    for t in range(T):
        d = torch.where(torch.isnan(yt[t]), 0.0, yt[t] - mean)
        a0 = a0 + d * d
        acc = [a + d * dk for a, dk in zip(acc, dl)]
        dl = [d] + dl[:-1]
    return torch.stack(acc, dim=1) / a0[:, None]


# ---------------------------------------------------------------------------
# GARCH(1,1): h_t = omega + alpha r_{t-1}^2 + beta h_{t-1}, and its adjoint
# ---------------------------------------------------------------------------

_GARCH_MODES = {"e": 0, "sum": 1, "both": 2, "last": 3}
_H_MIN = 1e-12
_TWO_PI = 2.0 * math.pi


def garch_fwd(rt, params, h0, zb, mode: str):
    """GARCH(1,1) variances of the ``[T, B]`` returns ``rt`` under ``params
    [B, 3]`` (``[omega, alpha, beta]``), start variance ``h0 [B]`` and
    first live step ``zb [B]`` (before it ``h = h0``; at it ``h0`` stands
    in for the unobserved squared return).

    ``mode``: ``"e"`` -> ``h [T, B]``; ``"sum"`` -> the per-series Gaussian
    sum ``sum_live log(2 pi h) + r^2 / h`` ``[B]``; ``"both"`` -> ``(h,
    sum)`` with the sum bitwise equal to ``"sum"``; ``"last"`` -> ``h`` at
    the last step ``[B]``.
    """
    if mode not in _GARCH_MODES:
        raise ValueError(f"unknown garch_fwd mode {mode!r}")
    T, B = _panel_shape("rt", rt)
    dev = rt.device
    _check("rt", rt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("h0", h0, (B,), dev)
    _check("zb", zb, (B,), dev)
    if not _on_cuda(dev):
        return garch_fwd_plain(rt, params, h0, zb, mode)
    h = torch.empty_like(rt) if mode in ("e", "both") else None
    ll = rt.new_empty(B) if mode in ("sum", "both") else None
    hl = rt.new_empty(B) if mode == "last" else None
    if B:
        par_t = params.t().contiguous()
        _launch("garch", "sts_garch_fwd", "garch_fwd", dev, _ptr(rt),
                _ptr(par_t), _ptr(h0), _ptr(zb), _ptr(h), _ptr(ll), _ptr(hl),
                B, T, _GARCH_MODES[mode])
    return {"e": h, "sum": ll, "both": (h, ll), "last": hl}[mode]


def garch_fwd_plain(rt, params, h0, zb, mode: str):
    """Plain PyTorch version of :func:`garch_fwd` (same recursion, same
    summation order)."""
    T, B = rt.shape
    omega, alpha, beta = params.unbind(1)
    hprev, r2p, acc = h0, rt.new_zeros(B), rt.new_zeros(B)
    hs = []
    for t in range(T):
        r2 = rt[t] * rt[t]
        r2in = torch.where(zb == t, h0, r2p)
        live = zb <= t
        hv = torch.where(live, omega + alpha * r2in + beta * hprev, h0)
        if mode in ("e", "both"):
            hs.append(hv)
        if mode in ("sum", "both"):
            hc = torch.clamp(hv, min=_H_MIN)
            acc = acc + torch.where(live, torch.log(_TWO_PI * hc) + r2 / hc,
                                    0.0)
        hprev, r2p = hv, r2
    h = (torch.stack(hs) if T else rt.new_empty(0, B)) \
        if mode in ("e", "both") else None
    return {"e": h, "sum": acc, "both": (h, acc), "last": hprev}[mode]


def garch_bwd(rt, params, h0, zb, ht, g, want_gr: bool = False):
    """Adjoint of :func:`garch_fwd` -> ``(gparams [B, 3], gh0 [B], gr [T, B]
    or None)``.

    ``ht`` is the forward's variance panel.  ``g`` is either a cotangent of
    ``h`` (``[T, B]``) or, for the likelihood sum, its per-series cotangent
    ``[B]`` (the per-step cotangent ``g (1/h - r^2/h^2)`` is formed in the
    kernel, zero through the 1e-12 clamp, and the sum's direct dependence
    on ``r`` joins ``gr``).  ``gr``, the cotangent of the returns ``rt``,
    is computed only with ``want_gr``.
    """
    T, B = _panel_shape("rt", rt)
    dev = rt.device
    _check("rt", rt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("h0", h0, (B,), dev)
    _check("zb", zb, (B,), dev)
    _check("ht", ht, (T, B), dev)
    g_is_ll = g.dim() == 1
    _check("g", g, (B,) if g_is_ll else (T, B), dev)
    if not _on_cuda(dev):
        return garch_bwd_plain(rt, params, h0, zb, ht, g, want_gr)
    gpar = rt.new_empty(3, B)
    gh0 = rt.new_empty(B)
    gr = torch.empty_like(rt) if want_gr else None
    if B:
        par_t = params.t().contiguous()
        _launch("garch", "sts_garch_bwd", "garch_bwd", dev, _ptr(rt),
                _ptr(par_t), _ptr(h0), _ptr(zb), _ptr(ht), _ptr(g),
                _ptr(gpar), _ptr(gh0), _ptr(gr), B, T, int(g_is_ll))
    return gpar.t(), gh0, gr


def garch_bwd_plain(rt, params, h0, zb, ht, g, want_gr: bool = False):
    """Plain PyTorch version of :func:`garch_bwd` (the kernel's order: t
    descending)."""
    T, B = rt.shape
    g_is_ll = g.dim() == 1
    alpha, beta = params[:, 1], params[:, 2]
    zero = rt.new_zeros(B)
    lam_next, dw, da, db, dh0 = zero, zero, zero, zero, zero
    grs = [None] * T
    for t in reversed(range(T)):
        rv, hv = rt[t], ht[t]
        rp = rt[t - 1] if t >= 1 else zero
        hp = ht[t - 1] if t >= 1 else h0
        live = zb <= t
        hc = torch.clamp(hv, min=_H_MIN)
        if g_is_ll:
            gt = torch.where(live & (hv >= _H_MIN),
                             g * (1.0 / hc - (rv * rv) / (hc * hc)), 0.0)
        else:
            gt = g[t]
        next_live = (zb < t + 1) & (t + 1 < T)
        gr2 = torch.where(next_live, alpha * lam_next, 0.0)
        lam = torch.where(live, gt + beta * lam_next, 0.0)
        dh0 = dh0 + torch.where(live, 0.0, gt)
        seed = zb == t
        dw = dw + lam
        da = da + lam * torch.where(seed, h0, rp * rp)
        db = db + lam * hp
        dh0 = dh0 + torch.where(live & seed, alpha * lam, 0.0)
        dh0 = dh0 + torch.where(live & (zb > t - 1), beta * lam, 0.0)
        if want_gr:
            v = gr2 * 2.0 * rv
            if g_is_ll:
                v = v + torch.where(live, g * 2.0 * rv / hc, 0.0)
            grs[t] = v
        lam_next = lam
    gr = None
    if want_gr:
        gr = torch.stack(grs) if T else rt.new_empty(0, B)
    return torch.stack([dw, da, db], dim=1), dh0, gr


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


# -- fill chain and autocorrelation (forward-only transforms) ---------------


def _chain_flags(outputs) -> tuple:
    outputs = tuple(outputs)
    if not outputs or any(o not in CHAIN_OUTPUTS for o in outputs):
        raise ValueError(f"outputs must be a non-empty subset of "
                         f"{CHAIN_OUTPUTS}, got {outputs!r}")
    return outputs, tuple(o in outputs for o in CHAIN_OUTPUTS)


def fill_linear_chain_folded(fp: FoldedPanel, outputs=CHAIN_OUTPUTS):
    """Fill chain on a resident :class:`~.layout.FoldedPanel`, computing
    ONLY the requested outputs -> a tuple of folded panels in the order of
    ``outputs`` (an ordered subset of ``("filled", "diff", "lag")``)."""
    outputs, which = _chain_flags(outputs)
    outs = fill_chain(fp.data, which)
    by_name = dict(zip([o for o, w in zip(CHAIN_OUTPUTS, which) if w], outs))
    return tuple(FoldedPanel(by_name[o], fp.b, fp.t) for o in outputs)


def fill_linear_chain(y):
    """Fill chain on a ``[B, T]`` panel -> ``(filled, lag-1 difference,
    lag-1 shift)``, each ``[B, T]`` (views of time-major storage).

    Matches ``fill_linear``, ``differences_at_lag(., 1)`` and ``lag(., 1)``
    composed: edge NaNs survive the fill; position 0 of the difference and
    of the shift is NaN."""
    return tuple(o.t() for o in fill_chain(time_major(y)))


def fill_linear(y):
    """Linear-interpolation fill ``[B, T]`` (the fill output only)."""
    return fill_chain(time_major(y), (True, False, False))[0].t()


def batch_autocorr(y, num_lags: int):
    """Sample autocorrelation ``[B, num_lags]`` of a ``[B, T]`` panel;
    matches ``univariate.autocorr`` row by row (valid-sample mean and
    denominator)."""
    return autocorr(time_major(y), num_lags)


def batch_autocorr_folded(fp: FoldedPanel, num_lags: int):
    """:func:`batch_autocorr` on a resident :class:`~.layout.FoldedPanel`,
    with no layout conversion."""
    return autocorr(fp.data, num_lags)


# -- GARCH(1,1) objective ----------------------------------------------------


class _GarchH(torch.autograd.Function):
    """Conditional variances ``[T, B]`` of the time-major returns,
    differentiable in the parameters, the returns and ``h0`` through the
    adjoint kernel (``zb`` is a constant)."""

    @staticmethod
    def forward(ctx, params, rt, h0, zb):
        h = garch_fwd(rt, params, h0, zb, "e")
        ctx.save_for_backward(params, rt, h0, zb, h)
        return h

    @staticmethod
    def backward(ctx, g):
        params, rt, h0, zb, h = ctx.saved_tensors
        gpar, gh0, gr = garch_bwd(rt, params, h0, zb, h, g.contiguous(),
                                  ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gr,
                gh0 if ctx.needs_input_grad[2] else None, None)


class _GarchLL(torch.autograd.Function):
    """Unscaled Gaussian log-likelihood sum ``[B]`` of the GARCH recursion,
    ``sum_live log(2 pi h_t) + r_t^2 / h_t``.

    Forward runs ``both`` (saving the variances) when a gradient is wanted
    and ``sum`` otherwise; the two sums are bitwise equal.  Backward is the
    adjoint kernel fed the per-series cotangent directly; the returns'
    cotangent is computed only when the returns require a gradient (the
    ARGARCH objective), and the ``h0`` cotangent flows on through PyTorch
    autograd into whatever computed ``h0``."""

    @staticmethod
    def forward(ctx, params, rt, h0, zb, save):
        if not save:
            return garch_fwd(rt, params, h0, zb, "sum")
        h, ll = garch_fwd(rt, params, h0, zb, "both")
        ctx.save_for_backward(params, rt, h0, zb, h)
        return ll

    @staticmethod
    def backward(ctx, gbar):
        params, rt, h0, zb, h = ctx.saved_tensors
        gpar, gh0, gr = garch_bwd(rt, params, h0, zb, h, gbar.contiguous(),
                                  ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gr,
                gh0 if ctx.needs_input_grad[2] else None, None, None)


def garch_variances(params, r, h0, zb):
    """Batched GARCH(1,1) conditional variances ``[B, T]`` (a view of
    time-major storage).

    ``params``: ``[B, 3]`` rows ``[omega, alpha, beta]``; ``r``: ``[B, T]``
    returns with the invalid prefix zeroed; ``h0``: ``[B]`` start variance;
    ``zb``: ``[B]`` first live position.  Differentiable in ``params``,
    ``r`` and ``h0`` through the adjoint kernel (``zb`` is constant)."""
    zb = zb.to(r.dtype).contiguous()
    return _GarchH.apply(params.contiguous(), time_major(r),
                         h0.to(r.dtype).contiguous(), zb).t()


def garch_h0_folded(rzt, mask, nvf):
    """The start variance ``h0 [B]``: the masked sample variance of the
    time-major returns ``rzt`` (zero outside ``mask``, the ``[T, B]``
    valid span) over ``nvf`` valid steps.  Differentiable in ``rzt``."""
    mean = rzt.sum(0) / nvf
    return torch.where(mask, (rzt - mean) ** 2, 0.0).sum(0) / nvf


def garch_neg_loglik_folded(params, rzt, h0, zb):
    """GARCH(1,1) Gaussian negative log-likelihood ``[B]`` from time-major
    returns ``rzt`` (zero outside each valid span), the start variance
    ``h0`` and the first live step ``zb``; matches
    :func:`garch_neg_loglik`.  Differentiable in ``params``, ``rzt`` and
    ``h0`` through the adjoint kernel."""
    return 0.5 * _GarchLL.apply(params, rzt, h0, zb,
                                _needs_grad(params, rzt, h0))


def garch_prefold(r, n_valid=None):
    """A ``[B, T]`` returns panel in the GARCH kernels' layout -> ``(rzt,
    mask, nvf, zb)``: the time-major copy zeroed outside each right-aligned
    valid span, that span as a ``[T, B]`` mask, the clamped valid count and
    the first live step (float ``[B]``)."""
    b, n = r.shape
    nv = (torch.full((b,), n, dtype=torch.int32, device=r.device)
          if n_valid is None else n_valid.to(torch.int32))
    zb = (n - nv).to(r.dtype)
    mask = torch.arange(n, dtype=r.dtype, device=r.device)[:, None] \
        >= zb[None, :]
    rzt = time_major(r).masked_fill_(~mask, 0.0)  # a copy
    return rzt, mask, torch.clamp(nv, min=1).to(r.dtype), zb


def garch_neg_loglik(params, r, n_valid=None):
    """Batched GARCH(1,1) Gaussian negative log-likelihood ``[B]`` of the
    ``[B, T]`` returns ``r``.

    Matches ``models.garch.neg_log_likelihood`` row by row: h0 is the
    masked sample variance of the valid span, the prefix is dead, and the
    likelihood sums over valid steps.  Differentiable in ``params`` and
    (through the returns and the variance seed) in ``r``."""
    rzt, mask, nvf, zb = garch_prefold(r, n_valid)
    h0 = garch_h0_folded(rzt, mask, nvf)
    return garch_neg_loglik_folded(params.contiguous(), rzt, h0, zb)

"""Per-series transforms (port of ``ops/univariate.py``), NaN-aware.

Every function takes a series ``[time]`` with NaN marking missing data and
works along the last axis, so a panel ``[keys, time]`` goes through the same
code with its rows independent (what the reference gets from ``jax.vmap``).
:func:`batched` lifts any ``[time]`` function to a panel with
``torch.vmap``.  The ``batch_*`` functions dispatch to the hand-written CUDA
kernels (``ops.cuda_kernels``) by structure only: ``backend="auto"`` takes
the kernel for a float32 panel on a CUDA device whose shape the kernel
takes, ``"cuda"`` insists (and raises where it cannot run), ``"eager"``
runs the plain PyTorch functions here on any device.

The trims, the partial autocorrelation, the cross-correlation, the
resampling functions and the spline fill run no kernel in the reference
either; here they are plain PyTorch on the input's device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .. import obs
from ..models.base import BACKENDS, resolve_backend
from . import cuda_kernels as ck
from .layout import FoldedPanel, fold_panel, unfold_panel

__all__ = [
    "first_not_nan_loc",
    "last_not_nan_loc",
    "autocorr",
    "pacf",
    "cross_corr",
    "lag",
    "lags",
    "differences_at_lag",
    "differences_of_order",
    "quotients",
    "price2ret",
    "fill_value",
    "fill_with_default",
    "fill_previous",
    "fill_next",
    "fill_nearest",
    "fill_linear",
    "fill_spline",
    "fillts",
    "trim_leading",
    "trim_trailing",
    "downsample",
    "upsample",
    "resample",
    "batched",
    "batch_autocorr",
    "batch_fill",
    "batch_fill_linear_chain",
]


def _isvalid(x):
    return ~torch.isnan(x)


# ---------------------------------------------------------------------------
# Locations of valid data
# ---------------------------------------------------------------------------


def first_not_nan_loc(x: torch.Tensor) -> torch.Tensor:
    """Index of the first non-NaN element, or ``size`` if all NaN."""
    valid = _isvalid(x)
    first = valid.to(torch.int8).argmax(-1)
    return torch.where(valid.any(-1), first, x.shape[-1])


def last_not_nan_loc(x: torch.Tensor) -> torch.Tensor:
    """Index of the last non-NaN element, or -1 if all NaN."""
    valid = _isvalid(x)
    rev = valid.flip(-1).to(torch.int8).argmax(-1)
    return torch.where(valid.any(-1), x.shape[-1] - 1 - rev, -1)


def trim_leading(x):
    """Drop the leading NaN run of one series (dynamic shape: a tensor
    stays a tensor, anything else comes back as a numpy array)."""
    xt = x if isinstance(x, torch.Tensor) else np.asarray(x)
    loc = int(first_not_nan_loc(torch.as_tensor(xt)))
    return xt[loc:]


def trim_trailing(x):
    """Drop the trailing NaN run of one series (dynamic shape, as
    :func:`trim_leading`)."""
    xt = x if isinstance(x, torch.Tensor) else np.asarray(x)
    loc = int(last_not_nan_loc(torch.as_tensor(xt)))
    return xt[:loc + 1]


# ---------------------------------------------------------------------------
# Correlation
# ---------------------------------------------------------------------------


def autocorr(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Sample autocorrelation at lags ``1..num_lags`` -> ``[num_lags]``.

    r_k = sum_{t=k}^{n-1} (x_t - m)(x_{t-k} - m) / sum_t (x_t - m)^2, over
    the valid (non-NaN) entries; the denominator uses the full valid sample.
    """
    n_t = x.shape[-1]
    if not 0 < num_lags < n_t:
        raise ValueError(
            f"num_lags must be in (0, series length {n_t}), got {num_lags}")
    valid = _isvalid(x)
    n = valid.sum(-1, keepdim=True)
    mean = torch.where(valid, x, 0.0).sum(-1, keepdim=True) \
        / torch.clamp(n, min=1)
    d = torch.where(valid, x - mean, 0.0)
    denom = (d * d).sum(-1)
    return torch.stack([(d[..., k:] * d[..., :n_t - k]).sum(-1) / denom
                        for k in range(1, num_lags + 1)], dim=-1)


def pacf(x: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Sample partial autocorrelation at lags ``1..num_lags`` ->
    ``[..., num_lags]``: the Durbin-Levinson recursion on
    :func:`autocorr`'s sample autocorrelations (the Yule-Walker solution),
    with its valid-sample convention for NaNs."""
    r = autocorr(x, num_lags)
    rho = torch.cat([torch.ones_like(r[..., :1]), r], dim=-1)
    idx = torch.arange(num_lags, device=x.device)
    phi = torch.zeros_like(r)  # the order-(k-1) model's coefficients
    out = []
    for k in range(1, num_lags + 1):
        prev = idx < k - 1
        num = rho[..., k] - torch.where(
            prev, phi * rho[..., (k - 1 - idx).abs()], 0.0).sum(-1)
        den = 1.0 - torch.where(prev, phi * rho[..., idx + 1], 0.0).sum(-1)
        pk = num / den
        # phi_j^(k) = phi_j^(k-1) - pk * phi_{k-j}^(k-1)
        # (indices past the end sit where prev is False: clamp them)
        rev = torch.where(
            prev, phi[..., (k - 2 - idx).abs().clamp(max=num_lags - 1)], 0.0)
        phi = torch.where(prev, phi - pk[..., None] * rev, phi)
        phi = torch.where(idx == k - 1, pk[..., None], phi)
        out.append(pk)
    return torch.stack(out, dim=-1)


def cross_corr(x: torch.Tensor, y: torch.Tensor,
               num_lags: int) -> torch.Tensor:
    """Cross-correlation of ``x`` with ``y`` at lags ``-num_lags ..
    num_lags`` -> ``[..., 2 num_lags + 1]``, over the non-NaN entries."""
    n = x.shape[-1]
    xd = x - torch.nanmean(x, dim=-1, keepdim=True)
    yd = y - torch.nanmean(y, dim=-1, keepdim=True)
    sx = torch.sqrt(torch.nansum(xd * xd, dim=-1))
    sy = torch.sqrt(torch.nansum(yd * yd, dim=-1))
    xz = torch.where(_isvalid(xd), xd, 0.0)
    yz = torch.where(_isvalid(yd), yd, 0.0)
    out = []
    for k in range(-num_lags, num_lags + 1):
        if k >= n:
            prod = torch.zeros_like(sx)
        elif k >= 0:
            prod = (xz[..., k:] * yz[..., :n - k]).sum(-1)
        else:
            prod = (yz[..., -k:] * xz[..., :n + k]).sum(-1)
        out.append(prod / (sx * sy))
    return torch.stack(out, dim=-1)


# ---------------------------------------------------------------------------
# Lags and differences
# ---------------------------------------------------------------------------


def lag(x: torch.Tensor, k: int) -> torch.Tensor:
    """Shift right by ``k``; the first ``k`` entries become NaN."""
    n = x.shape[-1]
    if not 0 <= k < n:
        raise ValueError(f"lag {k} must be in [0, {n}) for series length {n}")
    if k == 0:
        return x
    head = x.new_full((*x.shape[:-1], k), float("nan"))
    return torch.cat([head, x[..., :-k]], dim=-1)


def lags(x: torch.Tensor, max_lag: int,
         include_original: bool = True) -> torch.Tensor:
    """Lagged copies as columns -> ``[time, max_lag (+1)]``: the original
    first (if included), then lag 1, lag 2, ..."""
    cols = (([x] if include_original else [])
            + [lag(x, k) for k in range(1, max_lag + 1)])
    return torch.stack(cols, dim=-1)


def differences_at_lag(x: torch.Tensor, k: int) -> torch.Tensor:
    """``out[t] = x[t] - x[t-k]``; the first ``k`` entries are NaN."""
    return x - lag(x, k)


def differences_of_order(x: torch.Tensor, d: int) -> torch.Tensor:
    """Order-``d`` differencing (d lag-1 differences); the first ``d``
    entries are NaN."""
    for _ in range(d):
        x = differences_at_lag(x, 1)
    return x


def quotients(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``out[t] = x[t] / x[t-k]``; the first ``k`` entries are NaN."""
    return x / lag(x, k)


def price2ret(x: torch.Tensor, k: int = 1) -> torch.Tensor:
    """Simple returns ``x[t] / x[t-k] - 1``; the first ``k`` entries NaN."""
    return quotients(x, k) - 1.0


# ---------------------------------------------------------------------------
# Fill family
# ---------------------------------------------------------------------------


def fill_value(x: torch.Tensor, value) -> torch.Tensor:
    """Replace every NaN with ``value``."""
    return torch.where(_isvalid(x), x,
                       torch.as_tensor(value, dtype=x.dtype, device=x.device))


def fill_with_default(x: torch.Tensor, default=0.0) -> torch.Tensor:
    return fill_value(x, default)


def _prev_valid_idx(valid: torch.Tensor) -> torch.Tensor:
    """For each t, the index of the latest valid position <= t, or -1."""
    t = torch.arange(valid.shape[-1], device=valid.device)
    return torch.cummax(torch.where(valid, t, -1), dim=-1).values


def _next_valid_idx(valid: torch.Tensor) -> torch.Tensor:
    """For each t, the index of the earliest valid position >= t, or size."""
    n = valid.shape[-1]
    t = torch.arange(n, device=valid.device)
    cand = torch.where(valid, t, n).flip(-1)
    return torch.cummin(cand, dim=-1).values.flip(-1)


def _carry_valid_vals(valid, x, reverse: bool = False):
    """-> (value, seen): the value of the nearest valid position at-or-before
    t (``reverse=False``) or at-or-after t (``reverse=True``), 0.0 where
    there is none, and whether one exists on that side.  Values pass
    through ``nan_to_num`` as in the reference."""
    n = x.shape[-1]
    idx = _next_valid_idx(valid) if reverse else _prev_valid_idx(valid)
    seen = (idx < n) if reverse else (idx >= 0)
    vals = torch.where(valid, torch.nan_to_num(x), 0.0)
    got = torch.gather(vals, -1, torch.clamp(idx, 0, n - 1))
    return torch.where(seen, got, 0.0), seen


def fill_previous(x: torch.Tensor) -> torch.Tensor:
    """Forward fill (last observation carried forward); leading NaNs
    remain."""
    prev_val, seen = _carry_valid_vals(_isvalid(x), x)
    return torch.where(seen, prev_val, float("nan"))


def fill_next(x: torch.Tensor) -> torch.Tensor:
    """Backward fill (next observation carried backward); trailing NaNs
    remain."""
    next_val, seen = _carry_valid_vals(_isvalid(x), x, reverse=True)
    return torch.where(seen, next_val, float("nan"))


def fill_nearest(x: torch.Tensor) -> torch.Tensor:
    """Fill each NaN with the nearest valid value (ties -> previous)."""
    valid = _isvalid(x)
    n = x.shape[-1]
    t = torch.arange(n, device=x.device)
    ip = _prev_valid_idx(valid)
    inx = _next_valid_idx(valid)
    dp = torch.where(ip >= 0, t - ip, n + 1)
    dn = torch.where(inx < n, inx - t, n + 1)
    prev_val, _ = _carry_valid_vals(valid, x)
    next_val, _ = _carry_valid_vals(valid, x, reverse=True)
    filled = torch.where(dp <= dn, prev_val, next_val)
    any_side = (ip >= 0) | (inx < n)
    return torch.where(valid, x,
                       torch.where(any_side, filled, float("nan")))


def fill_linear(x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation across interior NaN gaps; edge NaNs remain."""
    valid = _isvalid(x)
    n = x.shape[-1]
    t = torch.arange(n, device=x.device)
    ip = _prev_valid_idx(valid)
    inx = _next_valid_idx(valid)
    interior = (ip >= 0) & (inx < n)
    ip_c = torch.clamp(ip, min=0)
    in_c = torch.clamp(inx, max=n - 1)
    span = torch.clamp(in_c - ip_c, min=1).to(x.dtype)
    w = (t - ip_c).to(x.dtype) / span
    prev_val, _ = _carry_valid_vals(valid, x)
    next_val, _ = _carry_valid_vals(valid, x, reverse=True)
    interp = prev_val * (1.0 - w) + next_val * w
    return torch.where(valid, x,
                       torch.where(interior, interp, float("nan")))


def fill_spline(x: torch.Tensor) -> torch.Tensor:
    """Natural cubic spline through the valid points; edge NaNs remain.

    The valid knots are compacted to the front by a stable sort, the
    natural spline's tridiagonal system is solved by the Thomas algorithm
    as a loop over time on ``[B]`` vectors (every series at once), and each
    interior NaN is evaluated on its bracketing knot interval.  Matches
    ``scipy.interpolate.CubicSpline(bc_type='natural')`` on the valid
    points, as the reference does.
    """
    shape = x.shape
    n = shape[-1]
    xb = x.reshape(-1, n)
    dtype = xb.dtype
    valid = _isvalid(xb)
    m = valid.sum(-1, keepdim=True)  # knots a series
    ar = torch.arange(n, device=x.device)
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    knot = ar[None, :] < m
    kx = torch.where(knot, order, n)  # knot positions, padded with n
    ky = torch.where(knot, torch.gather(xb, -1, order), 0.0)
    kxf = kx.to(dtype)
    h = torch.clamp(kxf[:, 1:] - kxf[:, :-1], min=1e-30)  # spacings
    dy = (ky[:, 1:] - ky[:, :-1]) / h
    # interior rows i = 1..m-2: h[i-1] M[i-1] + 2 (h[i-1] + h[i]) M[i]
    # + h[i] M[i+1] = 6 (dy[i] - dy[i-1]); M[0] = M[m-1] = 0
    z = xb.new_zeros(xb.shape[0], 1)
    interior = (ar[None, :] >= 1) & (ar[None, :] < torch.clamp(m - 1, min=1))
    h_lo = torch.cat([z, h], dim=1)
    h_hi = torch.cat([h, z], dim=1)
    a = torch.where(interior, h_lo, 0.0)
    b = torch.where(interior, 2.0 * (h_lo + h_hi), 1.0)
    c = torch.where(interior, h_hi, 0.0)
    rhs = torch.where(interior, torch.cat(
        [z, 6.0 * (dy[:, 1:] - dy[:, :-1]), z], dim=1)[:, :n], 0.0)
    # Thomas algorithm: forward elimination, then back substitution
    cp_prev = dp_prev = xb.new_zeros(xb.shape[0])
    cps, dps = [], []
    for t in range(n):
        denom = b[:, t] - a[:, t] * cp_prev
        cp_prev = c[:, t] / denom
        dp_prev = (rhs[:, t] - a[:, t] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    mi = xb.new_zeros(xb.shape[0])
    ms = [None] * n
    for t in reversed(range(n)):
        mi = dps[t] - cps[t] * mi
        ms[t] = mi
    M = torch.stack(ms, dim=1)  # second derivatives at the knots
    keys = torch.where(knot, kx, torch.iinfo(torch.int32).max).contiguous()
    tq = ar.expand(xb.shape[0], n).contiguous()
    j = torch.clamp(torch.searchsorted(keys, tq, right=True) - 1, 0, n - 2)
    x0, x1 = kxf.gather(1, j), kxf.gather(1, j + 1)
    y0, y1 = ky.gather(1, j), ky.gather(1, j + 1)
    M0, M1 = M.gather(1, j), M.gather(1, j + 1)
    hj = torch.clamp(x1 - x0, min=1e-30)
    tt = tq.to(dtype)
    A = (x1 - tt) / hj
    B = (tt - x0) / hj
    s = (A * y0 + B * y1
         + ((A ** 3 - A) * M0 + (B ** 3 - B) * M1) * (hj ** 2) / 6.0)
    inside = (_prev_valid_idx(valid) >= 0) & (_next_valid_idx(valid) < n)
    out = torch.where(valid, xb, torch.where(inside, s, float("nan")))
    return out.reshape(shape)


_FILLS: dict = {
    "value": None,  # needs an argument; handled in fillts
    "previous": fill_previous,
    "next": fill_next,
    "nearest": fill_nearest,
    "linear": fill_linear,
    "spline": fill_spline,
    "zero": lambda x: fill_value(x, 0.0),
}


def fillts(x: torch.Tensor, method: str, value=None) -> torch.Tensor:
    """Dispatch on the fill-method name (``UnivariateTimeSeries.fillts``)."""
    if method == "value":
        if value is None:
            raise ValueError("fill method 'value' requires a value")
        return fill_value(x, value)
    if method not in _FILLS:
        raise ValueError(f"unknown fill method {method!r}; options: "
                         f"{sorted(_FILLS)}")
    return _FILLS[method](x)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------


def downsample(x: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """Every ``n``-th element starting at ``offset``."""
    return x[..., offset::n]


def upsample(x: torch.Tensor, n: int, offset: int = 0,
             use_nan: bool = True) -> torch.Tensor:
    """Spread the elements ``n`` apart, padding with NaN (or 0) between."""
    out = x.new_full((*x.shape[:-1], x.shape[-1] * n),
                     float("nan") if use_nan else 0.0)
    out[..., offset::n] = x
    return out


def resample(x: torch.Tensor, ratio: int,
             aggr: Callable = torch.nanmean) -> torch.Tensor:
    """Aggregate consecutive windows of length ``ratio`` (e.g. hourly ->
    daily) with ``aggr(windows, dim=-1)``; a trailing partial window is
    dropped."""
    n_out = x.shape[-1] // ratio
    win = x[..., :n_out * ratio].reshape(*x.shape[:-1], n_out, ratio)
    return aggr(win, dim=-1)


# ---------------------------------------------------------------------------
# Batched (panel) variants: the kernel dispatch
# ---------------------------------------------------------------------------


def batched(fn: Callable, *static_args, **static_kwargs) -> Callable:
    """Lift a ``[time] -> ...`` function to ``[keys, time] -> ...``."""
    return torch.vmap(lambda v: fn(v, *static_args, **static_kwargs))


def _as_panel(panel):
    if isinstance(panel, (torch.Tensor, FoldedPanel)):
        return panel
    return torch.as_tensor(panel)


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")


def _use_kernel(backend: str, x: torch.Tensor, structural_ok: bool = True):
    return resolve_backend(backend, x, structural_ok) == "cuda"


def batch_autocorr(num_lags: int, backend: str = "auto") -> Callable:
    """``[keys, time] -> [keys, num_lags]`` autocorrelation.

    The CUDA kernel (``cuda_kernels.batch_autocorr``) runs for a float32
    panel on the card with ``0 < num_lags < min(T, 1024)``; elsewhere the
    plain :func:`autocorr` does.  A resident :class:`~.layout.FoldedPanel`
    goes to the kernel with no layout conversion.
    """
    _check_backend(backend)

    def run(panel):
        with obs.span("transforms.autocorr", lags=num_lags):
            panel = _as_panel(panel)
            if isinstance(panel, FoldedPanel):
                if _use_kernel(backend, panel.data,
                               ck.autocorr_structural_ok(num_lags, panel.t)):
                    return ck.batch_autocorr_folded(panel, num_lags)
                return autocorr(unfold_panel(panel), num_lags)
            if panel.ndim == 2 and _use_kernel(
                    backend, panel,
                    ck.autocorr_structural_ok(num_lags, panel.shape[1])):
                return ck.batch_autocorr(panel, num_lags)
            return autocorr(panel, num_lags)

    return run


def batch_fill(method: str, backend: str = "auto") -> Callable:
    """``[keys, time] -> [keys, time]`` fill; the CUDA kernel for
    ``"linear"`` on a float32 panel on the card."""
    _check_backend(backend)

    def run(panel):
        panel = _as_panel(panel)
        if (method == "linear" and panel.ndim == 2
                and _use_kernel(backend, panel)):
            return ck.fill_linear(panel)
        return fillts(panel, method)

    return run


def batch_fill_linear_chain(panel, backend: str = "auto", outputs=None):
    """fillLinear -> (filled, lag-1 difference, lag-1 shift) on a panel.

    On the kernel path (a float32 panel on the card) one pass computes the
    chain; elsewhere the plain functions compose it.  ``outputs`` (default
    all three) selects which results to compute AND return, in order:
    ``("diff",)`` writes only the difference.  A resident
    :class:`~.layout.FoldedPanel` input yields folded outputs with no layout
    conversion.
    """
    sel = ck.CHAIN_OUTPUTS if outputs is None else tuple(outputs)
    if not sel or any(o not in ck.CHAIN_OUTPUTS for o in sel):
        raise ValueError(f"outputs must be a non-empty subset of "
                         f"{ck.CHAIN_OUTPUTS}, got {outputs!r}")
    with obs.span("transforms.fill_chain"):
        return _fill_linear_chain(_as_panel(panel), backend, sel)


def _fill_linear_chain(panel, backend: str, sel: tuple) -> tuple:
    if isinstance(panel, FoldedPanel):
        if _use_kernel(backend, panel.data):
            return ck.fill_linear_chain_folded(panel, sel)
        nat = _fill_linear_chain(unfold_panel(panel), "eager", sel)
        return tuple(fold_panel(o) for o in nat)
    if panel.ndim == 2 and _use_kernel(backend, panel):
        fps = ck.fill_linear_chain_folded(fold_panel(panel), sel)
        return tuple(fp.data.t() for fp in fps)
    f = fill_linear(panel)
    by_name = {
        "filled": lambda: f,
        "diff": lambda: differences_at_lag(f, 1),
        "lag": lambda: lag(f, 1),
    }
    return tuple(by_name[o]() for o in sel)

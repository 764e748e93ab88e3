"""EWMA: exponentially weighted moving average smoothing (port of
``models/ewma.py``).

Smoothing recursion ``s_t = alpha x_t + (1 - alpha) s_{t-1}`` with
``alpha`` fitted per series by minimizing the one-step-ahead SSE (simple
exponential smoothing); a sigmoid keeps ``alpha`` in (0, 1) and the whole
panel is one batch through the lockstep batched L-BFGS (``utils.optim``).
Two backends compute the objective:

- ``"cuda"``: the hand-written EWMA kernels (``ops.cuda_kernels``) on a
  time-major panel the fit builds once, with the adjoint kernel as the
  gradient;
- ``"eager"``: plain PyTorch (:func:`sse`, a loop over time differentiated
  by autograd), on any device and dtype.

The fit has no straggler compaction on either backend, as the reference's
kernel path has none.

Parameter layout: ``[alpha]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import cuda_kernels as ck
from ..utils import optim
from .base import (FitResult, align_right, debatch, derive_status,
                   ensure_batched, maybe_align, resolve_align_mode,
                   resolve_backend, to_device)


def smooth(alpha, x, n_valid=None):
    """The EWMA recursion along the last axis of ``x``
    (``addTimeDependentEffects``): ``s_0 = x_0``; ``alpha`` is a scalar or
    has ``x``'s leading shape.

    ``n_valid`` marks a right-aligned valid span (``base.align_right``): the
    state seeds at the first valid value and the zero prefix emits 0.
    """
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    T = x.shape[-1]
    out = []
    if n_valid is None:
        s = x[..., 0]
        for t in range(T):
            s = alpha * x[..., t] + (1.0 - alpha) * s
            out.append(s)
    else:
        start = T - torch.as_tensor(n_valid, device=x.device)
        s = torch.zeros_like(x[..., 0])
        for t in range(T):
            xt = x[..., t]
            s = torch.where(start > t, 0.0, torch.where(
                start == t, xt, alpha * xt + (1.0 - alpha) * s))
            out.append(s)
    return torch.stack(out, dim=-1) if out else x.clone()


def unsmooth(alpha, s):
    """Invert :func:`smooth`: ``x_t = (s_t - (1-alpha) s_{t-1}) / alpha``
    (``removeTimeDependentEffects``).  The inverse does not exist at
    ``alpha = 0``: near-zero alpha returns NaN rather than overflowing."""
    alpha = torch.as_tensor(alpha, dtype=s.dtype, device=s.device)[..., None]
    prev = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    x = torch.where(alpha.abs() > 1e-12, (s - (1.0 - alpha) * prev) / alpha,
                    torch.nan)
    x[..., 0] = s[..., 0]
    return x


def sse(alpha, x, n_valid=None):
    """One-step-ahead squared error ``sum_t (x_t - s_{t-1})^2`` over valid
    ``t >= 1`` past the first valid step, along the last axis."""
    s = smooth(alpha, x, n_valid)
    err = x[..., 1:] - s[..., :-1]
    if n_valid is not None:
        T = x.shape[-1]
        start = T - torch.as_tensor(n_valid, device=x.device)
        t = torch.arange(1, T, device=x.device)
        err = torch.where(t > start[..., None], err, 0.0)
    return (err * err).sum(-1)


def fit(y, *, max_iters: int = 40, tol: Optional[float] = None,
        backend: str = "auto", align_mode: Optional[str] = None,
        device="cuda") -> FitResult:
    """Fit ``alpha`` per series by SSE minimization -> params
    ``[batch?, 1]``.

    ``y``: ``[time]`` or ``[batch, time]`` (numpy or tensor; moved to
    ``device``), NaN for missing; leading and trailing NaNs are tolerated
    (right-aligned masking).  Series with fewer than 3 valid points come
    back NaN and ``EXCLUDED``.  ``backend``: ``"cuda"`` (kernels),
    ``"eager"`` (plain PyTorch) or ``"auto"`` (``cuda`` for a float32
    panel on a CUDA device).  ``align_mode`` is the alignment hint
    (``base.resolve_align_mode``).
    """
    yb, single = ensure_batched(to_device(y, device))
    if tol is None:
        tol = 1e-8 if yb.dtype == torch.float64 else 1e-4
    backend = resolve_backend(backend, yb)
    align_mode = resolve_align_mode(yb, align_mode)
    with torch.no_grad():
        out = _fit_ewma(yb, max_iters, float(tol), backend, align_mode)
    return debatch(out, single)


def _ewma_objective(backend, ya, nv, n_eff):
    """The batched mean-SSE objective ``u [B, 1] -> [B]``."""
    if backend == "cuda":
        xzt, zb = ck.ewma_prefold(ya, nv)  # one layout conversion per fit

        def fb(u):
            alpha = optim.sigmoid_to_interval(u[:, 0], 0.0, 1.0)
            return ck.ewma_sse_folded(alpha, xzt, zb) / n_eff
    else:
        def fb(u):
            alpha = optim.sigmoid_to_interval(u[:, 0], 0.0, 1.0)
            return sse(alpha, ya, nv) / n_eff
    return fb


def _fit_ewma(yb, max_iters, tol, backend, align_mode):
    ya, nv = maybe_align(yb, align_mode)
    # optimize the MEAN squared error (same argmin, O(1) gradients); the
    # reported objective is the unscaled SSE
    n_eff = torch.clamp(nv - 1, min=1).to(ya.dtype)
    fb = _ewma_objective(backend, ya, nv, n_eff)
    del ya  # the cuda objective reads only its time-major copy
    u0 = yb.new_zeros(yb.shape[0], 1)
    res = optim.minimize_lbfgs_batched(fb, u0, max_iters=max_iters, tol=tol)
    alpha = optim.sigmoid_to_interval(res.x, 0.0, 1.0)
    ok = nv >= 3
    params = torch.where(ok[:, None], alpha, torch.nan)
    return FitResult(params, torch.where(ok, res.f * n_eff, torch.nan),
                     res.converged & ok, res.iters,
                     derive_status(ok, res.converged, params))


def forecast(params, y, n_future: int, *, backend: str = "auto",
             device="cuda"):
    """Flat forecasts at the last smoothed level -> ``[batch?, n_future]``.

    Rows with an empty span or non-finite params come back NaN.  Under
    ``"cuda"`` the last level is the last row of the forward kernel's
    smoothed series (``ewma_fwd`` mode ``e``).
    """
    yb, single = ensure_batched(to_device(y, device))
    pb = to_device(params, device, dtype=yb.dtype)
    if pb.ndim < 2:
        pb = pb.reshape(1, -1)
    backend = resolve_backend(backend, yb)
    with torch.no_grad():
        out = _forecast(pb, yb, n_future, backend)
    return debatch(out, single)


def _forecast(pb, yb, n_future: int, backend: str):
    ya, nv = align_right(yb)
    alpha = pb[:, 0].contiguous()
    if backend == "cuda":
        xzt, zb = ck.ewma_prefold(ya, nv)
        last = ck.ewma_fwd(xzt, alpha, zb, "e")[-1]
    else:
        last = smooth(alpha, ya, nv)[:, -1]
    # an empty span or failed-fit params must not yield a plausible 0.0
    last = torch.where((nv > 0) & torch.isfinite(alpha), last, torch.nan)
    return last[:, None].repeat(1, n_future)


def add_time_dependent_effects(params, x, *, device="cuda"):
    """Smooth ``x`` (``[time]`` or ``[batch, time]``) with ``params``
    (``[alpha]`` or ``[batch, 1]``): :func:`smooth` from ``s_0 = x_0``."""
    xb, single = ensure_batched(to_device(x, device))
    alpha = to_device(params, device, dtype=xb.dtype).reshape(-1)
    return debatch(smooth(alpha, xb), single)


def remove_time_dependent_effects(params, s, *, device="cuda"):
    """Invert :func:`add_time_dependent_effects` (:func:`unsmooth`)."""
    sb, single = ensure_batched(to_device(s, device))
    alpha = to_device(params, device, dtype=sb.dtype).reshape(-1)
    return debatch(unsmooth(alpha, sb), single)

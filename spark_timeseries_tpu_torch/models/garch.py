"""GARCH(1,1) and AR(1)+GARCH(1,1) volatility models (port of
``models/garch.py``).

Variance recursion ``h_t = omega + alpha r_{t-1}^2 + beta h_{t-1}`` with a
Gaussian log-likelihood; the constraints (omega > 0, alpha, beta >= 0,
alpha + beta < 1) hold through the reference's softplus/sigmoid
reparameterization, and the whole panel is one batch through the lockstep
batched L-BFGS (``utils.optim``).  Two backends compute the objective:

- ``"cuda"``: the hand-written GARCH kernels (``ops.cuda_kernels``) on a
  time-major panel the fit builds once, with the adjoint kernel as the
  gradient (for ARGARCH its returns and variance-seed cotangents flow on
  through PyTorch autograd into the AR(1) mean parameters);
- ``"eager"``: plain PyTorch (:func:`neg_log_likelihood`, a loop over time
  differentiated by autograd), on any device and dtype.

Parameter layouts (natural space):
- GARCH:   ``[omega, alpha, beta]``
- ARGARCH: ``[c, phi, omega, alpha, beta]``
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .. import obs
from ..ops import cuda_kernels as ck
from ..ops.layout import time_major
from ..utils import optim
from .base import (FitResult, align_right, as_generator, debatch,
                   debatch_fit, derive_status, ensure_batched, maybe_align,
                   require_pallas_for_count_evals, resolve_align_mode,
                   resolve_backend, to_device)

_TWO_PI = 2.0 * math.pi

# module-level so tests can monkeypatch the gate; the value and the cap
# sizing live with the compaction feature (utils.optim)
_COMPACT_MIN_BATCH = optim.COMPACT_MIN_BATCH


# -- transforms -------------------------------------------------------------


def _to_natural(u):
    """R^3 -> constrained ``(omega, alpha, beta)`` along the last axis."""
    omega = torch.logaddexp(u[..., 0], torch.zeros_like(u[..., 0])) + 1e-12
    persistence = torch.sigmoid(u[..., 1]) * (1.0 - 1e-6)  # alpha + beta
    frac = torch.sigmoid(u[..., 2])  # alpha share
    return torch.stack([omega, persistence * frac,
                        persistence * (1.0 - frac)], dim=-1)


def _from_natural(params):
    omega, alpha, beta = params.unbind(-1)
    u0 = optim.softplus_inverse(omega)
    pers = torch.clamp(alpha + beta, 1e-6, 1.0 - 1e-6)
    u1 = optim.interval_to_sigmoid(pers, 0.0, 1.0)
    u2 = optim.interval_to_sigmoid(alpha / pers, 0.0, 1.0)
    return torch.stack([u0, u1, u2], dim=-1)


# -- likelihood (the eager backend's objective) -------------------------------


def _unconditional_var(params):
    return params[..., 0] / torch.clamp(
        1.0 - params[..., 1] - params[..., 2], min=1e-6)


def _variance_scan(params, h0, r_sq_prev):
    """The single GARCH recursion ``h_t = omega + alpha r_sq_prev_t + beta
    h_{t-1}`` along the last axis, from ``h0``."""
    omega, alpha, beta = params.unbind(-1)
    c = omega[..., None] + alpha[..., None] * r_sq_prev
    h, hs = h0, []
    for ct in c.movedim(-1, 0):
        h = ct + beta * h
        hs.append(h)
    return torch.stack(hs, dim=-1)


def _valid_from(n_valid, r):
    """Right-aligned valid span: ``n_valid`` as a tensor (default: the whole
    series) and its start index."""
    T = r.shape[-1]
    if n_valid is None:
        n_valid = torch.full(r.shape[:-1], T, dtype=torch.int32,
                             device=r.device)
    n_valid = torch.as_tensor(n_valid, device=r.device)
    return n_valid, T - n_valid


def _masked_var(r, n_valid):
    """Variance over the right-aligned valid span, along the last axis."""
    T = r.shape[-1]
    t = torch.arange(T, device=r.device)
    m = (t >= (T - n_valid)[..., None]).to(r.dtype)
    n = torch.clamp(n_valid, min=1).to(r.dtype)
    mean = (r * m).sum(-1) / n
    return (m * (r - mean[..., None]) ** 2).sum(-1) / n


def variances(params, r, n_valid=None):
    """Conditional variances ``h_t`` along the last axis of ``r``; ``params``
    is ``[..., 3]``.  ``h_0`` is the sample variance of the valid span,
    which also stands in for the unobserved ``r_{-1}^2``.

    ``n_valid`` marks a right-aligned valid span (``base.align_right``): the
    recursion holds ``h = h_0`` through the prefix and seeds at the first
    valid step as the full-series recursion seeds at t=0.
    """
    n_valid, start = _valid_from(n_valid, r)
    T = r.shape[-1]
    h0 = _masked_var(r, n_valid)
    t = torch.arange(T, device=r.device)
    r2 = r * r
    r_sq_prev = torch.cat([torch.zeros_like(r2[..., :1]), r2[..., :-1]], -1)
    r_sq_prev = torch.where(t == start[..., None], h0[..., None], r_sq_prev)
    omega, alpha, beta = params.unbind(-1)
    c = (omega[..., None] + alpha[..., None] * r_sq_prev).movedim(-1, 0)
    dead = (t < start[..., None]).movedim(-1, 0)
    h, hs = h0, []
    for i in range(T):
        h = torch.where(dead[i], h0, c[i] + beta * h)
        hs.append(h)
    return torch.stack(hs, dim=-1)


def log_likelihood(params, r, n_valid=None):
    """Gaussian log-likelihood of returns under the variance recursion
    (summed over the valid span when ``n_valid`` is given)."""
    h = torch.clamp(variances(params, r, n_valid), min=1e-12)
    ll_t = torch.log(_TWO_PI * h) + (r * r) / h
    if n_valid is not None:
        n_valid, start = _valid_from(n_valid, r)
        t = torch.arange(r.shape[-1], device=r.device)
        ll_t = torch.where(t >= start[..., None], ll_t, 0.0)
    return -0.5 * ll_t.sum(-1)


def neg_log_likelihood(params, r, n_valid=None):
    return -log_likelihood(params, r, n_valid)


# -- fitting ----------------------------------------------------------------


def fit(r, *, max_iters: int = 80, tol: Optional[float] = None,
        backend: str = "auto", count_evals: bool = False,
        compact: bool = True, align_mode: Optional[str] = None,
        device="cuda") -> FitResult:
    """Fit GARCH(1,1) per series -> natural params ``[batch?, 3]``.

    ``r``: returns ``[time]`` or ``[batch, time]`` (numpy or tensor; moved
    to ``device``), NaN for missing.  ``backend``: ``"cuda"`` (kernels),
    ``"eager"`` (plain PyTorch) or ``"auto"`` (``cuda`` for a float32 panel
    on a CUDA device).  ``compact=False`` turns straggler compaction off
    (it engages at batches >= ``_COMPACT_MIN_BATCH``).  ``align_mode`` is
    the alignment hint (``base.resolve_align_mode``): an unknown name
    raises, a hint too strong for the data flags rows (DIVERGED / EXCLUDED)
    instead of misfitting them.  Rows with fewer than 10 valid
    observations are ``EXCLUDED``.  ``count_evals=True`` returns
    ``(FitResult, info)``, the optimizer's pass accounting
    (``utils.optim``), on either backend.
    """
    with obs.span("fit.garch") as sp:
        rb, single = ensure_batched(to_device(r, device))
        if tol is None:
            tol = 1e-7 if rb.dtype == torch.float64 else 1e-4
        backend = resolve_backend(backend, rb)
        sp.set(rows=rb.shape[0], time=rb.shape[1], backend=backend)
        require_pallas_for_count_evals(count_evals, backend)
        with torch.no_grad():
            out = _fit_garch(rb, max_iters, float(tol), backend, align_mode,
                             compact, count_evals)
        return debatch_fit(out, single, count_evals)


def _garch_prep(rb, align_mode: str):
    """Front half of the GARCH fit: alignment, the moment start (omega =
    0.1 var, alpha = 0.1, beta = 0.8) in transformed space and the
    mean-nll denominator; the reference's, unchanged."""
    ra, nv = maybe_align(rb, align_mode)
    var0 = _masked_var(ra, nv)
    nat0 = torch.stack([0.1 * torch.clamp(var0, min=1e-10),
                        torch.full_like(var0, 0.1),
                        torch.full_like(var0, 0.8)], dim=1)
    n_eff = torch.clamp(nv, min=1).to(ra.dtype)
    return ra, nv, _from_natural(nat0), n_eff


def _garch_objective(backend, ra, nv, n_eff):
    """The batched mean-nll objective ``u [B, 3] -> [B]`` and its straggler
    builder (``idxc -> objective over the gathered rows``)."""
    T = ra.shape[1]
    if backend == "cuda":
        # one layout conversion per fit; h0 depends only on the data
        rzt, mask, nvf, zb = ck.garch_prefold(ra, nv)
        h0 = ck.garch_h0_folded(rzt, mask, nvf)
        del mask

        def fb(u, rzt=rzt, h0=h0, zb=zb, ne=n_eff):
            optim.count_objective(u, T)
            return ck.garch_neg_loglik_folded(_to_natural(u), rzt, h0,
                                              zb) / ne

        def straggler(idxc):
            # gathered once, not at every evaluation of their objective
            sub = (rzt[:, idxc].contiguous(), h0[idxc], zb[idxc],
                   n_eff[idxc])
            return lambda u: fb(u, *sub)
    else:
        def fb(u, ra=ra, nv=nv, ne=n_eff):
            optim.count_objective(u, T)
            return neg_log_likelihood(_to_natural(u), ra, nv) / ne

        def straggler(idxc):
            sub = (ra[idxc], nv[idxc], n_eff[idxc])
            return lambda u: fb(u, *sub)
    return fb, straggler


def _minimize(fb, straggler, u0, max_iters, tol, compact, count_evals=False):
    bsz = u0.shape[0]
    gate = compact and bsz >= _COMPACT_MIN_BATCH
    return optim.minimize_lbfgs_batched(
        fb, u0, max_iters=max_iters, tol=tol, count_evals=count_evals,
        straggler_fun=straggler if gate else None,
        straggler_cap=optim.compaction_cap(bsz))


def _finalize(res, ok, n_eff, to_natural) -> FitResult:
    params = torch.where(ok[:, None], to_natural(res.x), torch.nan)
    return FitResult(params, torch.where(ok, res.f * n_eff, torch.nan),
                     res.converged & ok, res.iters,
                     derive_status(ok, res.converged, params))


def _fit_garch(rb, max_iters, tol, backend, align_mode, compact,
               count_evals=False):
    """The GARCH fit of a batched panel (``align_mode`` ``None`` probes
    it): preparation, optimizer and finalization, each in its span."""
    with obs.span("fit.prep"):
        ra, nv, u0, n_eff = _garch_prep(rb, resolve_align_mode(rb,
                                                               align_mode))
        fb, straggler = _garch_objective(backend, ra, nv, n_eff)
        del ra  # the cuda objective reads only its time-major copy
    res = _minimize(fb, straggler, u0, max_iters, tol, compact, count_evals)
    res, info = res if count_evals else (res, None)
    with obs.span("fit.finalize"):
        ok = nv >= 10  # GARCH needs a handful of observations to identify
        out = _finalize(res, ok, n_eff, _to_natural)
    return (out, info) if count_evals else out


# -- forecasting --------------------------------------------------------------


def forecast(params, r, n_future: int, *, backend: str = "auto",
             device="cuda"):
    """Variance-path forecast -> ``[batch?, n_future]`` conditional
    variances.

    ``h_{T+1} = omega + alpha r_T^2 + beta h_T`` from the in-sample
    recursion's end state, then ``h_{T+k} = omega + (alpha + beta)
    h_{T+k-1}``, decaying toward the unconditional variance.  Leading and
    trailing NaNs are tolerated (right-aligned span, as in :func:`fit`);
    rows with non-finite params or fewer than 2 valid observations come
    back NaN.  Under ``"cuda"`` ``h_T`` comes from the forward kernel's
    ``last`` mode (a read-only pass).
    """
    rb, single = ensure_batched(to_device(r, device))
    pb = to_device(params, device, dtype=rb.dtype)
    if pb.ndim == 1:
        pb = pb[None, :]
    backend = resolve_backend(backend, rb)
    with torch.no_grad():
        out = _forecast(pb, rb, n_future, backend)
    return debatch(out, single)


def _forecast(pb, rb, n_future: int, backend: str):
    ra, nv = align_right(rb)
    if backend == "cuda":
        rzt, mask, nvf, zb = ck.garch_prefold(ra, nv)
        h0 = ck.garch_h0_folded(rzt, mask, nvf)
        del mask
        h_last = ck.garch_fwd(rzt, pb.contiguous(), h0, zb, "last")
    else:
        h_last = variances(pb, ra, nv)[:, -1]
    omega, alpha, beta = pb.unbind(-1)
    h = omega + alpha * ra[:, -1] ** 2 + beta * h_last
    hs = []
    for _ in range(n_future):
        hs.append(h)
        h = omega + (alpha + beta) * h
    out = torch.stack(hs, dim=1) if hs else ra.new_empty(ra.shape[0], 0)
    ok = (nv >= 2) & torch.isfinite(pb).all(-1)
    return torch.where(ok[:, None], out, torch.nan)


# -- simulation --------------------------------------------------------------


def _params(params, device):
    p = to_device(params, device)
    return p if p.is_floating_point() else p.float()


def sample(params, gen, n: int, *, device="cuda"):
    """Simulate ``n`` returns from GARCH(1,1) (``GARCHModel.sample``):
    standard-normal innovations drawn from ``gen`` (a ``torch.Generator``
    on ``device`` or an integer seed) through
    :func:`add_time_dependent_effects`.  The draws are not the reference's
    (JAX keys); their distribution is the same."""
    p = _params(params, device)
    eps = torch.randn(n, generator=as_generator(gen, p.device),
                      device=p.device, dtype=p.dtype)
    return add_time_dependent_effects(p, eps, device=p.device)


def add_time_dependent_effects(params, x, *, device="cuda"):
    """White noise -> GARCH returns: scale by the running conditional vol.

    The recursion carries ``(h, r_prev)`` from ``h = `` the unconditional
    variance and ``r_prev = 0``; the variance path it induces is exactly
    what :func:`remove_time_dependent_effects` replays.
    """
    xb, single = ensure_batched(to_device(x, device))
    pb = to_device(params, device, dtype=xb.dtype)
    pb = pb[None, :] if pb.ndim == 1 else pb
    omega, alpha, beta = pb.unbind(-1)
    h = _unconditional_var(pb)
    r_prev = torch.zeros_like(h)
    out = []
    for t in range(xb.shape[1]):
        h = omega + alpha * r_prev ** 2 + beta * h
        r_prev = torch.sqrt(torch.clamp(h, min=1e-12)) * xb[:, t]
        out.append(r_prev)
    res = torch.stack(out, dim=1) if out else xb.clone()
    return debatch(res, single)


def remove_time_dependent_effects(params, r, *, device="cuda"):
    """GARCH returns -> standardized residuals ``r_t / sqrt(h_t)``, replaying
    :func:`add_time_dependent_effects`'s variance path so the pair round
    trips."""
    rb, single = ensure_batched(to_device(r, device))
    pb = to_device(params, device, dtype=rb.dtype)
    pb = pb[None, :] if pb.ndim == 1 else pb
    r_sq_prev = torch.cat([torch.zeros_like(rb[:, :1]), rb[:, :-1] ** 2], 1)
    h = _variance_scan(pb, _unconditional_var(pb), r_sq_prev)
    return debatch(rb / torch.sqrt(torch.clamp(h, min=1e-12)), single)


# ---------------------------------------------------------------------------
# AR(1) + GARCH(1,1)
# ---------------------------------------------------------------------------


def _argarch_to_natural(u):
    return torch.cat([u[..., :2], _to_natural(u[..., 2:])], dim=-1)


def _argarch_from_natural(params):
    return torch.cat([params[..., :2], _from_natural(params[..., 2:])],
                     dim=-1)


def argarch_neg_log_likelihood(params, y, n_valid=None):
    """``y_t = c + phi y_{t-1} + r_t`` with GARCH(1,1) innovations ``r``;
    ``params [..., 5]``, ``y [..., time]``."""
    c, phi = params[..., 0:1], params[..., 1:2]
    n = y.shape[-1]
    prev = torch.cat([y[..., :1], y[..., :-1]], dim=-1)
    r = y - c - phi * prev
    # condition on the first valid observation: its residual is excluded
    # from the variance seed and the likelihood sum
    nv, start = _valid_from(n_valid, y)
    t = torch.arange(n, device=y.device)
    r = torch.where(t <= start[..., None], 0.0, r)
    return neg_log_likelihood(params[..., 2:], r, nv - 1)


def fit_argarch(y, *, max_iters: int = 100, tol: Optional[float] = None,
                backend: str = "auto", compact: bool = True,
                align_mode: Optional[str] = None,
                device="cuda") -> FitResult:
    """Fit AR(1)+GARCH(1,1) -> natural params ``[batch?, 5]``
    (``ARGARCH.fitModel``).  Arguments as in :func:`fit`; rows with fewer
    than 12 valid observations are ``EXCLUDED``."""
    with obs.span("fit.argarch") as sp:
        yb, single = ensure_batched(to_device(y, device))
        if tol is None:
            tol = 1e-7 if yb.dtype == torch.float64 else 1e-4
        backend = resolve_backend(backend, yb)
        sp.set(rows=yb.shape[0], time=yb.shape[1], backend=backend)
        with torch.no_grad():
            out = _fit_argarch(yb, max_iters, float(tol), backend, align_mode,
                               compact)
        return debatch(out, single)


def _argarch_prep(yb, align_mode: str):
    """Front half of the ARGARCH fit: alignment, the AR(1)-by-
    autocorrelation + GARCH-moment start in transformed space and the
    mean-nll denominator; the reference's, unchanged."""
    ya, nv = maybe_align(yb, align_mode)
    T = ya.shape[1]
    m = (torch.arange(T, device=ya.device)[None, :]
         >= (T - nv)[:, None]).to(ya.dtype)
    nvf = torch.clamp(nv, min=1).to(ya.dtype)
    mean = (ya * m).sum(1) / nvf
    yc = (ya - mean[:, None]) * m
    phi0 = (yc[:, 1:] * yc[:, :-1]).sum(1) / torch.clamp(
        (yc * yc).sum(1), min=1e-12)
    phi0 = torch.clamp(phi0, -0.95, 0.95)
    c0 = mean * (1.0 - phi0)
    resid = (ya[:, 1:] - c0[:, None] - phi0[:, None] * ya[:, :-1]) * m[:, 1:]
    resid_var = (resid ** 2).sum(1) / nvf
    nat0 = torch.stack([c0, phi0, 0.1 * torch.clamp(resid_var, min=1e-8),
                        torch.full_like(c0, 0.1), torch.full_like(c0, 0.8)],
                       dim=1)
    n_eff = torch.clamp(nv - 1, min=1).to(ya.dtype)
    return ya, nv, _argarch_from_natural(nat0), n_eff


def _argarch_objective(backend, ya, nv, n_eff):
    """The batched mean-nll objective ``u [B, 5] -> [B]`` and its straggler
    builder.  Under ``"cuda"`` the returns are rebuilt from the AR(1) mean
    on the time-major panel at each evaluation; the GARCH kernels'
    cotangents of the returns and of the variance seed carry the gradient
    on to ``c`` and ``phi``."""
    T = ya.shape[1]
    if backend != "cuda":
        def fb(u, ya=ya, nv=nv, ne=n_eff):
            optim.count_objective(u, T)
            return argarch_neg_log_likelihood(_argarch_to_natural(u), ya,
                                              nv) / ne

        def straggler(idxc):
            sub = (ya[idxc], nv[idxc], n_eff[idxc])
            return lambda u: fb(u, *sub)
        return fb, straggler
    yat = time_major(ya)
    prevt = torch.cat([yat[:1], yat[:-1]])
    start = (T - nv).to(ya.dtype)
    # the GARCH span of n_valid - 1 steps: t > start, live from start + 1
    keep = torch.arange(T, dtype=ya.dtype, device=ya.device)[:, None] \
        > start[None, :]
    nvf = torch.clamp(nv - 1, min=1).to(ya.dtype)

    def fb(u, yat=yat, prevt=prevt, keep=keep, nvf=nvf, zb=start + 1,
           ne=n_eff):
        optim.count_objective(u, T)
        nat = _argarch_to_natural(u)
        rt = torch.where(keep, yat - nat[:, 0] - nat[:, 1] * prevt, 0.0)
        h0 = ck.garch_h0_folded(rt, keep, nvf)
        return ck.garch_neg_loglik_folded(nat[:, 2:].contiguous(), rt, h0,
                                          zb) / ne

    def straggler(idxc):
        sub = (yat[:, idxc].contiguous(), prevt[:, idxc].contiguous(),
               keep[:, idxc].contiguous(), nvf[idxc], start[idxc] + 1,
               n_eff[idxc])
        return lambda u: fb(u, *sub)
    return fb, straggler


def _fit_argarch(yb, max_iters, tol, backend, align_mode, compact):
    with obs.span("fit.prep"):
        ya, nv, u0, n_eff = _argarch_prep(yb, resolve_align_mode(yb,
                                                                 align_mode))
        fb, straggler = _argarch_objective(backend, ya, nv, n_eff)
        del ya  # the cuda objective reads only its time-major copies
    res = _minimize(fb, straggler, u0, max_iters, tol, compact)
    with obs.span("fit.finalize"):
        ok = nv >= 12
        return _finalize(res, ok, n_eff, _argarch_to_natural)


def argarch_sample(params, gen, n: int, *, device="cuda"):
    """Simulate ``n`` steps of AR(1)+GARCH(1,1) from ``params [5]`` (draws
    from ``gen``, a ``torch.Generator`` or an integer seed)."""
    p = _params(params, device)
    c, phi = p[0], p[1]
    r = sample(p[2:], gen, n, device=p.device)
    y_prev = c / torch.clamp(1.0 - phi, min=1e-6)
    ys = []
    for t in range(n):
        y_prev = c + phi * y_prev + r[t]
        ys.append(y_prev)
    return torch.stack(ys) if ys else r.clone()

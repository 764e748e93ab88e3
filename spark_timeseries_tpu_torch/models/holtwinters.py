"""Holt-Winters triple exponential smoothing (port of
``models/holtwinters.py``).

Additive and multiplicative seasonality with period ``m``; level, trend and
seasonal start values from the first two seasons; ``(alpha, beta, gamma)``
fitted per series by minimizing the one-step-ahead SSE, with the (0, 1)
bounds a sigmoid reparameterization and the whole panel one batch through
the lockstep batched L-BFGS (``utils.optim``).  Two backends compute the
objective:

- ``"cuda"``: the hand-written Holt-Winters kernels (``ops.cuda_kernels``)
  on a time-major panel and seeds the fit builds once, with the adjoint
  kernel as the gradient;
- ``"eager"``: plain PyTorch (:func:`sse`, a loop over time differentiated
  by autograd), on any device and dtype.

Straggler compaction engages on both backends at batches >=
``_COMPACT_MIN_BATCH``, once per seeded start.  Forecasts and fitted values
run the recursion in plain PyTorch, as the reference runs them in its scan.

Parameter layout (natural space): ``[alpha, beta, gamma]``.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import obs
from ..ops import cuda_kernels as ck
from ..ops.layout import time_major
from ..utils import optim
from .base import (FitResult, align_right, debatch, debatch_fit,
                   derive_status, ensure_batched, maybe_align,
                   require_pallas_for_count_evals, resolve_align_mode,
                   resolve_backend, to_device)

_EPS = 1e-12
MODEL_TYPES = ("additive", "multiplicative")

# module-level so tests can monkeypatch the gate; the value and the cap
# sizing live with the compaction feature (utils.optim)
_COMPACT_MIN_BATCH = optim.COMPACT_MIN_BATCH

# seeded multi-start inits (natural (alpha, beta, gamma) space), probed in
# order: the long-standing default first, then two deterministic probes at
# opposite corners of the smoothing cube (the reference's table).  The
# multiplicative SSE surface is non-convex; keeping each row's best basin
# over 2-3 spread inits collapses its local-optimum tail.
_MULTISTART_NATS = (
    (0.3, 0.1, 0.1),
    (0.7, 0.25, 0.4),
    (0.12, 0.05, 0.6),
)


def _init_state(y, period: int, multiplicative: bool, start=None):
    """Start values from the first two seasons along the last axis of ``y``
    -> ``(level0, trend0, seasonal0 [..., period])``.

    ``start`` (integer, ``y``'s leading shape) points at each row's first
    valid observation; each season's window is clamped into ``[0, T -
    period]``, as the reference's ``lax.dynamic_slice`` clamps it, so rows
    with fewer than two valid seasons still get finite seeds.
    """
    if start is None:
        s1 = y[..., :period]
        s2 = y[..., period:2 * period]
    else:
        T = y.shape[-1]
        st = torch.as_tensor(start, device=y.device).to(torch.long)
        ar = torch.arange(period, device=y.device)
        s1 = torch.gather(y, -1, torch.clamp(st, 0, T - period)[..., None]
                          + ar)
        s2 = torch.gather(y, -1, torch.clamp(st + period, 0, T - period)
                          [..., None] + ar)
    level0 = s1.mean(-1)
    trend0 = (s2.mean(-1) - level0) / period
    if multiplicative:
        seasonal0 = s1 / torch.clamp(level0, min=_EPS)[..., None]
    else:
        seasonal0 = s1 - level0[..., None]
    return level0, trend0, seasonal0


def _run(params, y, period: int, multiplicative: bool, n_valid=None):
    """Run the smoothing recursion along the last axis -> ``(one-step
    forecasts [..., T], (level, trend, seasonal [..., period]))``.

    ``params`` is ``[..., 3]``.  ``n_valid`` marks a right-aligned valid
    span: the state holds through the zero prefix, so the recursion starts
    at the first valid observation.  The seasonal ring is a list of
    ``period`` tensors indexed by ``t mod period``, starting from the
    pre-rotated seeds (``ring[p] = s0[(p - start) mod period]``): the same
    values as the reference's rotating concatenation.  The end state is
    rotated as the reference's: ``seasonal[..., k]`` is the value of step
    ``T + k``.
    """
    alpha, beta, gamma = params[..., 0], params[..., 1], params[..., 2]
    # the complements once, not per step: the same values, fewer launches
    oa, ob, og = 1 - alpha, 1 - beta, 1 - gamma
    T = y.shape[-1]
    start = None if n_valid is None else (
        T - torch.as_tensor(n_valid, device=y.device).to(torch.long))
    level, trend, s0 = _init_state(y, period, multiplicative, start)
    if start is not None:
        pos = (torch.arange(period, device=y.device) - start[..., None]) \
            % period
        s0 = torch.gather(s0, -1, pos)
        lives = start[..., None] <= torch.arange(T, device=y.device)
    ring = list(s0.unbind(-1))
    preds = []
    for t in range(T):
        yt = y[..., t]
        slot = t % period
        s = ring[slot]
        lt = level + trend
        if multiplicative:
            pred = lt * s
            new_level = alpha * yt / torch.clamp(s, min=_EPS) + oa * lt
            new_s = gamma * yt / torch.clamp(new_level, min=_EPS) + og * s
        else:
            pred = lt + s
            new_level = alpha * (yt - s) + oa * lt
            new_s = gamma * (yt - new_level) + og * s
        new_trend = beta * (new_level - level) + ob * trend
        if start is not None:
            live = lives[..., t]
            new_level = torch.where(live, new_level, level)
            new_trend = torch.where(live, new_trend, trend)
            new_s = torch.where(live, new_s, s)
        level, trend, ring[slot] = new_level, new_trend, new_s
        preds.append(pred)
    seasonal = torch.stack([ring[(T + k) % period] for k in range(period)],
                           dim=-1)
    return torch.stack(preds, dim=-1), (level, trend, seasonal)


def sse(params, y, period: int, multiplicative: bool, n_valid=None):
    """One-step-ahead SSE along the last axis, skipping the seeded first
    season of the valid span."""
    preds, _ = _run(params, y, period, multiplicative, n_valid)
    T = y.shape[-1]
    start = 0 if n_valid is None else (
        T - torch.as_tensor(n_valid, device=y.device))
    t = torch.arange(T, device=y.device)
    err = torch.where(t >= torch.as_tensor(start, device=y.device)[..., None]
                      + period, y - preds, 0.0)
    return (err * err).sum(-1)


def fit(y, period: int, model_type: str = "additive", *,
        max_iters: int = 60, tol: Optional[float] = None,
        backend: str = "auto", count_evals: bool = False,
        compact: bool = True, n_starts: Optional[int] = None,
        align_mode: Optional[str] = None, device="cuda") -> FitResult:
    """Fit ``(alpha, beta, gamma)`` per series -> params ``[batch?, 3]``.

    ``y``: ``[time]`` or ``[batch, time]`` (numpy or tensor; moved to
    ``device``), NaN for missing; rows need two full seasons of valid data
    (``nv >= 2 period``), else they come back NaN and ``EXCLUDED``.
    ``backend``: ``"cuda"`` (kernels; ``0 < period <= 1024``), ``"eager"``
    (plain PyTorch) or ``"auto"`` (``cuda`` for a float32 panel on a CUDA
    device whose period the kernels take).  ``compact=False`` turns
    straggler compaction off.  ``n_starts`` (default 3 multiplicative, 1
    additive; at most ``len(_MULTISTART_NATS)``) runs the optimizer from
    that many seeded inits and keeps each row's best basin
    (:func:`_select_best_start`).  ``align_mode`` is the alignment hint
    (``base.resolve_align_mode``).  ``count_evals=True`` returns
    ``(FitResult, info)``, the optimizer's pass accounting
    (``utils.optim``) of the FIRST start, with ``info["n_starts"]`` as its
    multiplier, as in the reference; on either backend.
    """
    if model_type not in MODEL_TYPES:
        raise ValueError(
            f"model_type must be additive|multiplicative, got {model_type!r}")
    multiplicative = model_type == "multiplicative"
    if n_starts is None:
        n_starts = 3 if multiplicative else 1
    if not 1 <= int(n_starts) <= len(_MULTISTART_NATS):
        raise ValueError(
            f"n_starts must be in [1, {len(_MULTISTART_NATS)}] (one per "
            "seeded init in holtwinters._MULTISTART_NATS), got "
            f"{n_starts}")
    with obs.span("fit.holtwinters") as sp:
        yb, single = ensure_batched(to_device(y, device))
        if yb.shape[1] < 2 * period:
            raise ValueError(f"need at least two seasons ({2 * period} "
                             f"points), got {yb.shape[1]}")
        if tol is None:
            tol = 1e-7 if yb.dtype == torch.float64 else 1e-4
        if backend == "cuda":
            ck._hw_check_period(period)
        backend = resolve_backend(backend, yb,
                                  structural_ok=ck.hw_structural_ok(period))
        sp.set(rows=yb.shape[0], time=yb.shape[1], backend=backend)
        require_pallas_for_count_evals(count_evals, backend)
        with torch.no_grad():
            out = _fit_hw(yb, period, multiplicative, max_iters, float(tol),
                          backend, align_mode, compact, int(n_starts),
                          count_evals)
        return debatch_fit(out, single, count_evals)


def _hw_objective(backend, ya, nv, n_err, period: int, multiplicative: bool,
                  align_mode: str):
    """The batched mean-SSE objective ``u [B, 3] -> [B]`` and its straggler
    builder (``idxc -> objective over the gathered rows``)."""
    T = ya.shape[1]
    if backend == "cuda":
        # seeds depend on the data only: computed once per fit and shared
        # by every start; the dense mode takes the gather-free windows
        seeds = ck.hw_seeds(ya, period, multiplicative,
                            None if align_mode == "dense" else nv)
        yt = time_major(ya)

        def fb(u, yt=yt, seeds=seeds, ne=n_err):
            optim.count_objective(u, T)
            nat = optim.sigmoid_to_interval(u, 0.0, 1.0)
            return ck.hw_sse_folded(nat, yt, seeds, period,
                                    multiplicative) / ne

        def straggler(idxc):
            # gathered once, not at every evaluation of their objective
            sub = (yt[:, idxc].contiguous(), tuple(s[idxc] for s in seeds),
                   n_err[idxc])
            return lambda u: fb(u, *sub)
    else:
        def fb(u, ya=ya, nv=nv, ne=n_err):
            optim.count_objective(u, T)
            nat = optim.sigmoid_to_interval(u, 0.0, 1.0)
            return sse(nat, ya, period, multiplicative, nv) / ne

        def straggler(idxc):
            sub = (ya[idxc], nv[idxc], n_err[idxc])
            return lambda u: fb(u, *sub)
    return fb, straggler


def _fit_hw(yb, period, multiplicative, max_iters, tol, backend, align_mode,
            compact, n_starts, count_evals=False):
    """The Holt-Winters fit of a batched panel (``align_mode`` ``None``
    probes it): preparation, one optimizer a start and the finalization,
    each in its span."""
    with obs.span("fit.prep"):
        align_mode = resolve_align_mode(yb, align_mode)
        ya, nv = maybe_align(yb, align_mode)
        # optimize the MEAN one-step squared error: same argmin as the
        # SSE, an O(1) gradient scale for the relative stopping rule
        n_err = torch.clamp(nv - period, min=1).to(ya.dtype)
        fb, straggler = _hw_objective(backend, ya, nv, n_err, period,
                                      multiplicative, align_mode)
        del ya  # the cuda objective reads only its time-major copy
    bsz = yb.shape[0]
    gate = compact and bsz >= _COMPACT_MIN_BATCH
    results, info = [], None
    for start, nat0 in enumerate(_MULTISTART_NATS[:n_starts]):
        u0 = optim.interval_to_sigmoid(
            torch.tensor(nat0, dtype=yb.dtype, device=yb.device), 0.0, 1.0)
        # pass accounting reports the first start's passes
        want = count_evals and start == 0
        res = optim.minimize_lbfgs_batched(
            fb, u0.expand(bsz, 3).contiguous(), max_iters=max_iters, tol=tol,
            count_evals=want, straggler_fun=straggler if gate else None,
            straggler_cap=optim.compaction_cap(bsz))
        if want:
            res, info = res
            info = {**info, "n_starts": n_starts}
        results.append(res)
    with obs.span("fit.finalize"):
        ok = nv >= 2 * period  # the seed needs two full seasons of data
        out = _finalize_hw_fit(_select_best_start(results), ok, n_err)
    return (out, info) if count_evals else out


def _select_best_start(starts):
    """Per-row basin selection across seeded multi-start results (the
    reference's rule, deterministic across precisions):

    1. candidates = converged starts (all starts when none converged)
       within 0.1% relative of the row's best final objective;
    2. among them the smoothest model (smallest alpha + beta + gamma), ties
       to the earliest start.
    """
    if len(starts) == 1:
        return starts[0]
    inf = float("inf")
    xs = torch.stack([r.x for r in starts])  # [S, B, 3]
    fs = torch.stack([torch.nan_to_num(r.f, nan=inf, posinf=inf)
                      for r in starts])
    convs = torch.stack([r.converged for r in starts])
    eligible = torch.where(convs.any(0)[None, :], convs, True)
    f_elig = torch.where(eligible, fs, inf)
    best_f = f_elig.min(0).values
    near = eligible & (f_elig <= best_f[None, :] * (1 + 1e-3) + 1e-12)
    smooth = optim.sigmoid_to_interval(xs, 0.0, 1.0).sum(-1)
    sel = torch.argmin(torch.where(near, smooth, inf), dim=0)

    def take(field):
        return torch.stack([getattr(r, field) for r in starts]).gather(
            0, sel[None, :])[0]

    return starts[0]._replace(
        x=xs.gather(0, sel[None, :, None].expand(1, *xs.shape[1:]))[0],
        f=take("f"), converged=take("converged"), iters=take("iters"),
        grad_norm=take("grad_norm"))


def _finalize_hw_fit(res, ok, n_err) -> FitResult:
    """Optimizer result -> FitResult; the reported objective is the
    unscaled SSE."""
    params = torch.where(ok[:, None], optim.sigmoid_to_interval(
        res.x, 0.0, 1.0), torch.nan)
    return FitResult(params, torch.where(ok, res.f * n_err, torch.nan),
                     res.converged & ok, res.iters,
                     derive_status(ok, res.converged, params))


def _params_batch(params, device, dtype):
    pb = to_device(params, device, dtype=dtype)
    return pb[None, :] if pb.ndim == 1 else pb


def forecast(params, y, period: int, n_future: int,
             model_type: str = "additive", *, device="cuda"):
    """h-step-ahead forecasts from the end state -> ``[batch?,
    n_future]``: additive ``(level + h trend) + seasonal``, multiplicative
    ``(level + h trend) * seasonal``.  Leading and trailing NaNs are
    tolerated (right-aligned span); rows with fewer than two seasons of
    valid data come back NaN."""
    multiplicative = model_type == "multiplicative"
    yb, single = ensure_batched(to_device(y, device))
    pb = _params_batch(params, device, yb.dtype)
    with torch.no_grad():
        ya, nv = align_right(yb)
        _, (level, trend, seasonal) = _run(pb, ya, period, multiplicative,
                                           nv)
        h = torch.arange(1, n_future + 1, dtype=yb.dtype, device=yb.device)
        seas = seasonal[:, torch.arange(n_future, device=yb.device) % period]
        base = level[:, None] + h[None, :] * trend[:, None]
        out = base * seas if multiplicative else base + seas
        # seeding needs two full seasons (the fit's gate): shorter spans
        # would return finite values from clamped seed windows
        out = torch.where((nv >= 2 * period)[:, None], out, torch.nan)
    return debatch(out, single)


def fitted(params, y, period: int, model_type: str = "additive", *,
           device="cuda"):
    """In-sample one-step-ahead predictions ``[batch?, time]`` of a dense
    panel (``addTimeDependentEffects`` analog for diagnostics)."""
    multiplicative = model_type == "multiplicative"
    yb, single = ensure_batched(to_device(y, device))
    pb = _params_batch(params, device, yb.dtype)
    with torch.no_grad():
        preds, _ = _run(pb, yb, period, multiplicative)
    return debatch(preds, single)

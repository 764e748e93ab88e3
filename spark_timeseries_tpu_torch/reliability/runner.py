"""Resilient fit execution: sanitize -> fit -> retry ladder -> fallback
(port of ``reliability/runner.py``).

The batch analog of Spark task retry: per-series numerics ran inside
executor tasks, and a failed task was simply re-run elsewhere.  Here a
"task" is a ROW of one batched fit, so recovery is a gather/re-fit/scatter
ladder:

1. **Sanitize** the input panel (``reliability.sanitize``): repair or
   exclude rows no fit can survive (inf, interior NaN, constant, all-NaN).
2. **Primary fit** via the model's public ``fit`` — one call over the
   whole batch, exactly as without the ladder (on the card, the CUDA
   kernels).
3. **Retry rung**: rows that came back non-converged or non-finite are
   gathered into a small padded batch (``optim.retry_cap`` bounds the
   distinct batch shapes) and re-fit with a larger iteration budget and,
   where the model supports ``init_params``, a deterministically perturbed
   init.
4. **Fallback rung**: rows still failing are re-fit on the conservative
   settings — no straggler compaction, the largest budget and a larger
   init perturbation — on the ``auto`` backend, the fits' default (the
   CUDA kernels on the card; the reference's rung switches to its
   portable ``scan`` backend, a recorded difference).
   ``utils.linalg.ridge_solve`` independently falls back from the
   unpivoted Cholesky to a general solve for non-SPD rows.
5. Rows that survive nothing are marked ``DIVERGED`` (NaN params, flagged)
   instead of silently propagating NaNs into downstream aggregates.

Rows reach a rung only by their convergence: an exception from any rung
(a kernel that does not build or launch included) propagates unchanged —
nothing here turns an error into a fallback.  Per-row outcomes are
reported as :class:`~.status.FitStatus` codes; ``meta`` records what every
rung attempted and recovered.  The results are host numpy arrays: the
ladder reads the status, params and nll of the whole batch to the host
once per rung.
"""

from __future__ import annotations

import inspect
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..utils import optim
from .sanitize import sanitize as _sanitize
from .status import STATUS_DTYPE, FitStatus, status_counts

__all__ = ["RetryRung", "ResilientFitResult", "default_ladder", "resilient_fit"]


class RetryRung(NamedTuple):
    """One rung of the retry ladder."""

    name: str  # label recorded in meta
    status: int  # FitStatus granted to rows this rung rescues
    kwargs: dict  # fit-kwarg overrides (filtered to the fit's signature)
    perturb: float = 0.0  # init perturbation scale (models with init_params)


class ResilientFitResult(NamedTuple):
    """Batched fit output with per-row status and run metadata.

    Field layout extends ``models.base.FitResult``; arrays are host-side
    numpy (the ladder assembles rows across several fit calls).
    """

    params: np.ndarray  # [batch, k]
    neg_log_likelihood: np.ndarray  # [batch]
    converged: np.ndarray  # [batch] bool
    iters: np.ndarray  # [batch]
    status: np.ndarray  # [batch] int8 FitStatus codes
    meta: dict


def default_ladder(fit_fn: Callable, base_iters: Optional[int] = None) -> tuple:
    """The standard two-rung ladder, filtered to what ``fit_fn`` accepts.

    Rung 1 (``RETRIED``) re-fits with a LARGER iteration budget (at least
    double the primary fit's ``base_iters`` when known) and a small
    perturbed init; rung 2 (``FALLBACK``) re-fits with compaction
    disabled, a larger budget still and a larger perturbation, on the
    ``auto`` backend: the kernels on the card, plain PyTorch only for a
    panel on the CPU (the reference's rung names its portable ``scan``
    backend).  Models
    without a ``backend``/``max_iters`` knob simply get whichever
    overrides their signature supports.
    """
    base = int(base_iters) if base_iters else 60
    return (
        RetryRung("retry", int(FitStatus.RETRIED),
                  {"max_iters": max(120, 2 * base)}, perturb=0.05),
        RetryRung("fallback", int(FitStatus.FALLBACK),
                  {"max_iters": max(240, 4 * base), "backend": "auto",
                   "compact": False},
                  perturb=0.2),
    )


def _accepted_kwargs(fit_fn: Callable, kwargs: dict) -> dict:
    """Drop overrides the fit's signature does not accept."""
    try:
        params = inspect.signature(fit_fn).parameters
    except (TypeError, ValueError):  # builtins / C callables: pass through
        return dict(kwargs)
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values()):
        return dict(kwargs)
    return {k: v for k, v in kwargs.items() if k in params}


def _host(x) -> np.ndarray:
    """A fit field as a host numpy array (one read)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _failed_mask(params, nll, conv) -> np.ndarray:
    """Rows whose fit cannot be trusted: non-converged or non-finite."""
    # a column at a time: numpy's reduction over a short last axis is
    # several times slower on a million rows
    finite = np.isfinite(nll)
    for j in range(params.shape[-1]):
        finite &= np.isfinite(params[..., j])
    return ~(conv & finite)


def _structurally_excluded(res, conv) -> np.ndarray:
    """Rows the model itself refused (too short / empty): retry cannot help."""
    if res.status is None:
        return np.zeros(conv.shape, bool)
    return _host(res.status) == FitStatus.EXCLUDED


def _recoverable_oom(e: BaseException) -> bool:
    """Allocation failures are recoverable one layer up (a chunk driver's
    backoff) — no crash dump for them here."""
    from .plan import is_resource_exhausted

    return is_resource_exhausted(e)


@obs.dump_on_failure("resilient_fit", unless=_recoverable_oom)
def resilient_fit(
    fit_fn: Callable,
    y,
    *,
    policy: str = "impute",
    ladder: Optional[Sequence[RetryRung]] = None,
    sanitize: bool = True,
    max_retry_rows: Optional[int] = None,
    seed: int = 0,
    **fit_kwargs,
) -> ResilientFitResult:
    """Run ``fit_fn(y, **fit_kwargs)`` with sanitization and the retry ladder.

    ``fit_fn`` is any public model fit (``models.arima.fit`` partials
    included) returning a ``FitResult``.  ``y`` is a tensor (kept on its
    device) or an array-like, moved to ``fit_kwargs["device"]`` (default
    ``"cuda"``, as every entry point).  ``policy`` is the sanitizer's
    non-finite policy (``"impute"`` / ``"exclude"`` / ``"raise"``);
    ``sanitize=False`` skips the pass entirely (rows the models reject
    still come back ``EXCLUDED`` via their own status output).  ``ladder``
    overrides :func:`default_ladder`; an empty ladder means failed rows go
    straight to ``DIVERGED``.  ``seed`` drives the deterministic init
    perturbation of retry rungs (the reference's numpy draws, moved to the
    panel's device).

    COST NOTE: every non-converged row enters the ladder, and each rung is
    a fit of its own (up to four times the primary budget, without
    compaction).  A panel where a sizable fraction of rows legitimately
    fails to converge within budget can therefore spend longer in the
    ladder than in the primary fit.  For latency-critical serving, bound
    the ladder with ``max_retry_rows`` (rows beyond the cap skip the
    ladder and are flagged ``DIVERGED`` directly, ladder rungs recorded in
    ``meta`` either way), pass a shorter ``ladder``, or ``ladder=()`` to
    disable retries entirely.

    An ``align_mode=`` entry in ``fit_kwargs`` (a chunk driver's static
    alignment plan) is forwarded to ``fit_fn`` only when its signature
    accepts it, and is downgraded to ``"general"`` whenever the sanitizer
    actually repaired or excluded rows — the repairs change the panel's
    NaN pattern, so a stronger panel-level claim may no longer hold on
    the cleaned values.

    Healthy rows are fitted bit-identically to a direct ``fit_fn`` call on
    the SANITIZED panel: the ladder only ever re-fits the failed subset,
    scattering recovered rows back without touching their neighbors.  On a
    panel with nothing to repair, the primary fit is the direct call on
    the panel itself.  Exceptions propagate: the ladder handles rows that
    did not converge, never a fit that raised.
    """
    if isinstance(y, torch.Tensor):
        yb = y
    else:
        from ..models.base import to_device  # it imports this package

        yb = to_device(y, fit_kwargs.get("device", "cuda"))
    single = yb.ndim == 1
    if single:
        yb = yb[None, :]
    b = yb.shape[0]

    # static align-mode hint (a chunk driver's per-walk plan): held back
    # from the fit until the sanitizer has run — repairs and exclusions
    # CHANGE the panel's NaN pattern, so a panel-level "dense" /
    # "no-trailing" claim may no longer hold on the cleaned values
    align_hint = fit_kwargs.pop("align_mode", None)

    if sanitize:
        rep = _sanitize(yb, policy=policy)
        y_clean, status, san_meta = rep.values, rep.status.copy(), rep.meta
    else:
        y_clean = yb
        status = np.zeros(b, STATUS_DTYPE)
        san_meta = {"policy": "off"}
    if align_hint is not None:
        if san_meta.get("rows_sanitized") or san_meta.get("rows_excluded"):
            align_hint = "general"
        if "align_mode" in _accepted_kwargs(fit_fn, {"align_mode": None}):
            fit_kwargs = {**fit_kwargs, "align_mode": align_hint}

    with obs.span("fit.primary", rows=b):
        res = fit_fn(y_clean, **fit_kwargs)
        params = _host(res.params).copy()
        nll = _host(res.neg_log_likelihood).copy()
        conv = _host(res.converged).copy()
        iters = _host(res.iters).copy()
    excluded = (status == FitStatus.EXCLUDED) | _structurally_excluded(
        res, conv)
    status = np.maximum(
        status, np.where(excluded, FitStatus.EXCLUDED, 0)
    ).astype(STATUS_DTYPE)

    failed = _failed_mask(params, nll, conv) & ~excluded
    # ladder size cap: rows past the cap skip the ladder entirely (they
    # stay in ``failed`` and are flagged DIVERGED below), bounding the
    # worst-case ladder cost on mass-non-convergence panels
    retryable = failed.copy()
    over_cap = 0
    if max_retry_rows is not None and int(retryable.sum()) > max_retry_rows:
        skipped = np.nonzero(retryable)[0][max_retry_rows:]
        retryable[skipped] = False
        over_cap = skipped.size
    rungs = (default_ladder(fit_fn, fit_kwargs.get("max_iters"))
             if ladder is None else tuple(ladder))
    # register every rung's counters up front (zero-valued when no row ever
    # enters the ladder) so the run summary always reports the full
    # ladder-rung vocabulary, not just the rungs that happened to fire
    for rung in rungs:
        obs.counter(f"ladder.{rung.name}.attempted")
        obs.counter(f"ladder.{rung.name}.rescued")
    rung_meta = []
    rng = np.random.default_rng(seed)
    supports_init = "init_params" in _accepted_kwargs(
        fit_fn, {"init_params": None}
    )

    for depth, rung in enumerate(rungs):
        idx = np.nonzero(retryable)[0]
        if idx.size == 0:
            break
        # gather the failed subset into an aligned bucket (same contract as
        # the optimizer's straggler compaction: out-of-range pad rows are
        # copies of a real row whose results are dropped on the scatter)
        cap = optim.retry_cap(idx.size)
        pad_idx = optim.gather_pad_indices(idx, cap)
        y_sub = y_clean[torch.as_tensor(pad_idx, device=y_clean.device)]
        kw = {**fit_kwargs, **rung.kwargs}
        if supports_init and rung.perturb:
            # deterministic perturbed init: best-seen params of the failed
            # rows, jittered relative to their own magnitude
            base = np.nan_to_num(params[pad_idx], nan=0.0,
                                 posinf=0.0, neginf=0.0)
            jitter = rung.perturb * (1.0 + np.abs(base)) * rng.standard_normal(
                base.shape
            )
            kw["init_params"] = torch.as_tensor(
                base + jitter, dtype=y_clean.dtype, device=y_clean.device)
        kw = _accepted_kwargs(fit_fn, kw)
        with obs.span(f"fit.rung.{rung.name}", rows=int(idx.size), cap=cap):
            sub = fit_fn(y_sub, **kw)
            s_params = _host(sub.params)[: idx.size]
            s_nll = _host(sub.neg_log_likelihood)[: idx.size]
            s_conv = _host(sub.converged)[: idx.size]
            s_iters = _host(sub.iters)[: idx.size]
        sub_failed = _failed_mask(s_params, s_nll, s_conv)
        rescued = idx[~sub_failed]
        if rescued.size:
            keep = np.nonzero(~sub_failed)[0]
            params[rescued] = s_params[keep]
            nll[rescued] = s_nll[keep]
            conv[rescued] = s_conv[keep]
            iters[rescued] = s_iters[keep]
            status[rescued] = np.maximum(status[rescued], rung.status)
            failed[rescued] = False
            retryable[rescued] = False
        rung_meta.append({
            "rung": rung.name, "depth": depth,
            "attempted": int(idx.size), "rescued": int(rescued.size),
            "kwargs": {k: v for k, v in rung.kwargs.items()},
        })
        obs.counter(f"ladder.{rung.name}.attempted").add(int(idx.size))
        obs.counter(f"ladder.{rung.name}.rescued").add(int(rescued.size))

    # survivors of every rung: flag DIVERGED and refuse to hand back
    # non-finite params as if they were estimates
    if failed.any():
        params[failed] = np.nan
        nll[failed] = np.nan
        conv[failed] = False
        status[failed] = np.maximum(status[failed], FitStatus.DIVERGED)

    meta = {
        "sanitize": san_meta,
        "ladder": rung_meta,
        "retry_rows_over_cap": over_cap,
        "status_counts": status_counts(status),
    }
    if single:
        return ResilientFitResult(
            params[0], nll[0], conv[0], iters[0], status[0], meta
        )
    return ResilientFitResult(params, nll, conv, iters, status, meta)


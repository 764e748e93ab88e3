"""Deterministic fault injection for the reliability layer, the data-fault
and fit-wrapper half (port of ``reliability/faultinject.py``).

Every rung of the resilience ladder must be exercisable in CPU tests — a
recovery path that only runs when a real card runs out of memory is a
recovery path that has never run.  This module provides:

**Data faults** (panel corruptions): NaN holes inside the valid span, inf
spikes, constant rows, all-NaN rows, and explosive near-collinear rows
whose float32 normal equations go indefinite (the non-SPD
Hannan-Rissanen case).  All are driven by an explicit seed and draw the
reference's positions from the reference's numpy generator, so the same
seed corrupts the same entries in both packages.  A numpy array comes back
as a new numpy array; a tensor comes back as a new tensor on its own
device, written in one scatter (a full-width panel on the card never
travels to the host).

**Behavioral faults** (fit-function wrappers): :func:`failing_fit` forces
designated rows to report non-convergence for a fixed number of fit calls
— rows are recognized by a value fingerprint, so the same row keeps
failing as the ladder gathers it into retry sub-batches —
:func:`oom_fit` raises a ``RESOURCE_EXHAUSTED``-marked error whenever the
batch exceeds a row threshold, and :func:`hanging_fit` stalls designated
fit calls past any watchdog budget.

The commit, lane, request, transport and disk faults of the reference
module drive the journaled chunk walk and the serving layer, which are not
ported yet; they arrive with them.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import numpy as np
import torch

from .status import STATUS_DTYPE, FitStatus

__all__ = [
    "SimulatedCrash",
    "SimulatedResourceExhausted",
    "inject_nan_rows",
    "inject_inf_rows",
    "make_constant_rows",
    "make_all_nan_rows",
    "make_explosive_rows",
    "nonspd_gram",
    "failing_fit",
    "oom_fit",
    "hanging_fit",
]


class SimulatedResourceExhausted(RuntimeError):
    """Stands in for an allocation failure.

    Carries the same ``RESOURCE_EXHAUSTED`` marker the reference runtime's
    error message does, so ``reliability.plan.is_resource_exhausted``
    treats it as it treats ``torch.cuda.OutOfMemoryError``.
    """

    def __init__(self, nbytes: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
            f"{nbytes} bytes. (simulated by reliability.faultinject)"
        )


def _copy(y):
    """A writable copy of the panel: a tensor on its own device, else a
    numpy array of the input's dtype."""
    if isinstance(y, torch.Tensor):
        return y.clone()
    return np.array(y, dtype=np.asarray(y).dtype, copy=True)


def _scatter(out, rows, cols, values):
    """``out[rows, cols] = values`` (host index arrays) on either kind."""
    if isinstance(out, torch.Tensor):
        dev = out.device
        out[torch.as_tensor(rows, device=dev),
            torch.as_tensor(cols, device=dev)] = torch.as_tensor(
                values, dtype=out.dtype, device=dev)
    else:
        out[rows, cols] = values
    return out


def _set_rows(out, rows, values):
    """``out[rows] = values`` (a scalar, or one row a listed row)."""
    if isinstance(out, torch.Tensor):
        idx = torch.as_tensor(rows, device=out.device)
        out[idx] = torch.as_tensor(values, dtype=out.dtype, device=out.device)
    else:
        out[rows] = values
    return out


def inject_nan_rows(y, rows, frac: float = 0.2, seed: int = 0):
    """Punch NaN holes INSIDE the valid span of the given rows.

    Edge positions are kept so the holes are interior — the fault the
    sanitizer must repair, not legitimate raggedness.
    """
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    n_holes = max(1, int(frac * (t - 2)))
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    cols = np.stack([rng.choice(np.arange(1, t - 1), size=n_holes,
                                replace=False) for _ in rows])
    return _scatter(out, np.repeat(rows, n_holes), cols.ravel(), np.nan)


def inject_inf_rows(y, rows, n: int = 3, seed: int = 0):
    """Replace ``n`` interior positions of each given row with +/-inf."""
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    cols, vals = [], []
    for _ in rows:  # the reference's draw order: positions, then signs
        cols.append(rng.choice(np.arange(1, t - 1), size=n, replace=False))
        vals.append(np.where(rng.random(n) < 0.5, np.inf, -np.inf))
    return _scatter(out, np.repeat(rows, n), np.concatenate(cols),
                    np.concatenate(vals))


def make_constant_rows(y, rows, value: float = 1.0):
    """Overwrite the given rows with a constant (zero innovation variance)."""
    return _set_rows(_copy(y), np.atleast_1d(rows), value)


def make_all_nan_rows(y, rows):
    """Overwrite the given rows with NaN everywhere (nothing to fit)."""
    return _set_rows(_copy(y), np.atleast_1d(rows), np.nan)


def make_explosive_rows(y, rows, growth: float = 1.35, seed: int = 0):
    """Overwrite rows with an explosive near-collinear AR process.

    ``y_t ~= growth * y_{t-1}`` spans ~130 orders of magnitude over a 1k
    panel: in float32 the Hannan-Rissanen lag Gram matrix accumulates to
    an (effectively) indefinite / overflowed system — the non-SPD
    normal-equations fault — and CSS optimization on the row is hopeless
    within any budget, exercising the DIVERGED terminal.
    """
    out = _copy(y)
    rng = np.random.default_rng(seed)
    t = out.shape[1]
    rows = np.atleast_1d(rows)
    if rows.size == 0:
        return out
    block = np.stack([(growth ** np.arange(t))
                      * (1.0 + 0.01 * rng.standard_normal(t))
                      for _ in rows])
    if not isinstance(out, torch.Tensor):
        block = block.astype(out.dtype)  # the reference's row assignment
    return _set_rows(out, rows, block)


def nonspd_gram(k: int = 4, dtype=np.float32) -> np.ndarray:
    """A deterministic symmetric matrix with one (slightly) negative
    eigenvalue — what float32 accumulation can make of a rank-deficient
    ``X^T X``.  For unit tests of ``utils.linalg.ridge_solve``'s
    non-positive-pivot fallback."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    eig = np.ones(k)
    eig[-1] = -1e-3
    return (q @ np.diag(eig) @ q.T).astype(dtype)


def _tails(y) -> np.ndarray:
    """Each row's last value as float64, read alone (a panel on the card
    sends only its last column to the host)."""
    if isinstance(y, torch.Tensor):
        return y[:, -1].cpu().numpy().astype(np.float64)
    return np.asarray(y)[:, -1].astype(np.float64)


def _fingerprints(y, rows) -> np.ndarray:
    """Identify rows by their last value (float64-exact).

    The resilient runner re-fits failed rows on the SAME (sanitized) data,
    so a row's tail value is stable across ladder rungs and sub-batch
    gathers; designated rows should be NaN-free so the sanitizer passes
    them through bit-identically.
    """
    tails = _tails(y)[np.atleast_1d(rows)]
    if np.unique(tails).size != tails.size or np.isnan(tails).any():
        raise ValueError(
            "failing_fit fingerprints must be unique, finite tail values; "
            "pick clean rows (or perturb their last sample)"
        )
    return tails


def failing_fit(fit_fn: Callable, y, rows, n_failures: int = 1) -> Callable:
    """Wrap ``fit_fn`` so the given rows of ``y`` report non-convergence.

    Each designated row fails (``converged=False``, NaN params/nll,
    ``DIVERGED`` model status) for its first ``n_failures`` fit calls that
    include it, then behaves normally — so ``n_failures=1`` drives the
    ``RETRIED`` transition, ``n_failures=2`` drives ``FALLBACK`` (with the
    default two-rung ladder), and a large value drives ``DIVERGED``.
    Budgets decrement once per CALL per row (pad rows duplicating a failed
    row do not burn extra budget).  Any other row whose last value equals
    a designated row's fails with it: pick designated rows whose tails are
    unique in the whole panel.
    """
    budgets = {fp: n_failures for fp in _fingerprints(y, rows)}

    # functools.wraps: signature introspection (the runner's per-rung
    # kwarg filtering) must see the REAL fit's signature, not (yb, **kw)
    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        res = fit_fn(yb, **kwargs)
        tails = _tails(yb)
        mask = np.zeros(tails.shape[0], bool)
        for fp in list(budgets):
            if budgets[fp] <= 0:
                continue
            hit = tails == fp
            if hit.any():
                mask |= hit
                budgets[fp] -= 1
        if not mask.any():
            return res
        m = torch.as_tensor(mask, device=res.params.device)
        params = torch.where(m[:, None], torch.nan, res.params)
        nll = torch.where(m, torch.nan, res.neg_log_likelihood)
        conv = res.converged & ~m
        status = res.status
        if status is not None:
            status = torch.where(
                m, torch.tensor(int(FitStatus.DIVERGED), dtype=torch.int8,
                                device=status.device), status
            ).to(torch.int8)
        return res._replace(
            params=params, neg_log_likelihood=nll, converged=conv,
            status=status,
        )

    return wrapped


def oom_fit(fit_fn: Callable, max_rows: int) -> Callable:
    """Wrap ``fit_fn`` to raise a simulated RESOURCE_EXHAUSTED whenever the
    batch has more than ``max_rows`` rows — a chunk driver must back off
    to at most ``max_rows`` before the fit is allowed to run."""

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        shape = np.asarray(tuple(yb.shape))
        if int(shape[0]) > max_rows:
            raise SimulatedResourceExhausted(int(shape.prod()) * 4)
        return fit_fn(yb, **kwargs)

    return wrapped


# ---------------------------------------------------------------------------
# process faults (deadline watchdog)
# ---------------------------------------------------------------------------


class SimulatedCrash(BaseException):
    """In-process stand-in for a SIGKILL: derives from ``BaseException`` so
    no ``except Exception`` recovery path can accidentally swallow it — a
    journaled driver must survive by durability, not by catching it."""


def hanging_fit(fit_fn: Callable, hang_calls, sleep_s: float = 30.0) -> Callable:
    """Wrap ``fit_fn`` so the given (0-based) call indices stall ``sleep_s``
    before fitting — a stand-in for a hung kernel build or pathological
    optimizer tail.  Under ``watchdog.call_with_deadline`` with a budget
    below ``sleep_s`` the caller gets ``DeadlineExceeded``; the abandoned
    worker thread wakes later, runs the real fit, and its result is
    discarded."""
    hang = set(int(i) for i in np.atleast_1d(hang_calls))
    state = {"calls": 0}

    @functools.wraps(fit_fn)
    def wrapped(yb, **kwargs):
        i = state["calls"]
        state["calls"] += 1
        if i in hang:
            time.sleep(sleep_s)
        return fit_fn(yb, **kwargs)

    return wrapped

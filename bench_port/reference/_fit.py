"""Judging a batched fit against a plain model, and the control fit.

A model module (``arima``, ``garch``, ``holtwinters`` beside this file)
gives ``prepare(rows [b, T], dtype, acc)``, which returns the prepared data
of a block of rows with its ``eligible`` mask and its ``objective`` over
unconstrained points ``[S, b', k] -> [S, b']`` (summed over the series, the
unscaled objective that the fit reports), ``to_free`` and ``to_params``
between parameters and those points, ``start`` (the control's starting
point) and ``STEP`` (the finite-difference step in free space).

The comparison reads, for every row, the program's parameters, reported
objective and status:

- ``status_mismatch``: rows whose EXCLUDED status disagrees with the
  model's eligibility rule, plus rows reported OK with non-finite
  parameters (an exact comparison);
- ``nll_gap``: the widest gap between the reported objective and the
  plain model's objective at the reported parameters, over ``max(1, |f|)``;
- ``newton_gain``: the widest fall of the plain objective that one
  float64 Newton step from the reported parameters finds, over
  ``max(1, |f|)``: how far the answer is from a local optimum;
- ``newton_gain_median``: the median of that fall over the eligible
  rows, which a fault that touches every row moves even where the widest
  one of a sound run is of the same size.

An eligible row with non-finite parameters or objective reads infinite on
every gap.
"""

from typing import NamedTuple

import torch

from . import _newton

# the program's per-row status codes (FitStatus), as its results carry them
OK, DIVERGED, EXCLUDED = 0, 4, 5


class Fit(NamedTuple):
    """A fit's answer, in the fields the program's results carry."""

    params: torch.Tensor
    neg_log_likelihood: torch.Tensor
    converged: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor


def judge(model, data: torch.Tensor, fit, block: int) -> dict:
    """Judge ``fit`` (the program's answer for the ``[B, T]`` panel
    ``data``) row by row in blocks of ``block`` rows, in float64."""
    f64 = torch.float64
    params = fit.params.to(f64)
    nll = fit.neg_log_likelihood.to(f64)
    status = fit.status.to(torch.int64)
    mism, gap, falls = 0, 0.0, []
    for r0 in range(0, data.shape[0], block):
        r1 = min(r0 + block, data.shape[0])
        prep = model.prepare(data[r0:r1], f64, f64)
        el = prep.eligible
        st, p, nl = status[r0:r1], params[r0:r1], nll[r0:r1]
        finite = torch.isfinite(p).all(-1)
        mism += int(((st == EXCLUDED) != ~el).sum())
        mism += int(((st == OK) & ~finite).sum())
        answered = finite & torch.isfinite(nl)
        lost = int((el & ~answered).sum())
        if lost:
            gap = float("inf")
            falls.append(torch.full((lost,), float("inf"), dtype=f64,
                                    device=p.device))
        rows = el & answered
        if not bool(rows.any()):
            continue
        obj = prep.objective(rows)
        f0, df = _newton.gain(obj, model.to_free(p[rows]), model.STEP)
        scale = f0.abs().clamp(min=1.0)
        gap = max(gap, float(((nl[rows] - f0).abs() / scale).max()))
        falls.append(df / scale)
    fall = torch.cat(falls) if falls else torch.zeros(1, dtype=f64)
    return {"status_mismatch": mism, "nll_gap": gap,
            "newton_gain": float(fall.max()),
            "newton_gain_median": float(fall.median())}


def control(model, data: torch.Tensor, dtype, block: int,
            iters: int = 12) -> Fit:
    """The plain model fitted in ``dtype`` (its recursion in ``dtype``, its
    sums in float32): Newton steps from the model's own start, with
    derivatives by differences of ``dtype`` values over a step the
    precision can resolve."""
    outs = []
    for r0 in range(0, data.shape[0], block):
        r1 = min(r0 + block, data.shape[0])
        prep = model.prepare(data[r0:r1], dtype, torch.float32)
        el = prep.eligible
        k = model.K
        p = torch.full((r1 - r0, k), float("nan"), dtype=torch.float32,
                       device=data.device)
        f = torch.full((r1 - r0,), float("nan"), dtype=torch.float32,
                       device=data.device)
        if bool(el.any()):
            obj = prep.objective(el)
            v0 = prep.start(el).to(torch.float32)
            h = max(model.STEP, 4 * torch.finfo(dtype).eps)
            v, fv = _newton.minimize(lambda V: obj(V).to(torch.float32),
                                     v0, h, iters)
            p[el] = model.to_params(v.double()).to(torch.float32)
            f[el] = fv.to(torch.float32)
        ok = el & torch.isfinite(p).all(-1) & torch.isfinite(f)
        st = torch.where(~el, EXCLUDED, torch.where(ok, OK, DIVERGED))
        outs.append((p, f, ok, st.to(torch.int8)))
    p, f, ok, st = (torch.cat(x) for x in zip(*outs))
    return Fit(p, f, ok, torch.full_like(st, iters, dtype=torch.int32), st)

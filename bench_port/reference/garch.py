"""Plain GARCH(1,1) of percent returns, and the volatility pipeline.

Over each row's valid span ``[first, last]`` of returns ``r``: ``h0`` is
the span's population variance, ``h_first = omega + alpha h0 + beta h0``
and ``h_t = omega + alpha r_{t-1}^2 + beta h_{t-1}`` after it (``h``
floored at 1e-12); the objective is the Gaussian negative log-likelihood
``1/2 sum (log(2 pi h_t) + r_t^2 / h_t)``.  Free parameters: ``log
omega``, ``logit(alpha + beta)``, ``logit(alpha / (alpha + beta))``.  A
row is eligible with at least 10 valid returns; its span has no interior
gap (the pipeline fills them).

The pipeline: prices -> fillLinear -> lag-1 difference (the returns) ->
autocorrelations of returns and of squared returns -> the GARCH fit.
"""

import math
import sys

import torch

from . import _fit, transforms

K = 3
STEP = 1e-4
BLOCK = 25000  # rows a block of the transforms (float64 [b, 2520])
FIT_BLOCK = 100000
MIN_VALID = 10
FLOOR = 1e-12


def _logit(p):
    p = p.clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def to_free(params):
    omega, alpha, beta = params.unbind(-1)
    pers = alpha + beta
    return torch.stack([torch.log(omega.clamp(min=1e-300)), _logit(pers),
                        _logit(alpha / pers.clamp(min=1e-300))], -1)


def to_params(v):
    omega = torch.exp(v[..., 0])
    pers = torch.sigmoid(v[..., 1])
    share = torch.sigmoid(v[..., 2])
    return torch.stack([omega, pers * share, pers * (1 - share)], -1)


class Prepared:
    def __init__(self, rows: torch.Tensor, dtype, acc):
        r = rows.to(dtype)
        self.dtype, self.acc = dtype, acc
        b, n = r.shape
        valid = ~torch.isnan(r)
        t = torch.arange(n, device=r.device)
        nv = valid.sum(1)
        first = torch.where(valid, t, n).amin(1)
        last = torch.where(valid, t, -1).amax(1)
        span = (t[None] >= first[:, None]) & (t[None] <= last[:, None])
        gapless = ~(span & ~valid).any(1)
        self.eligible = gapless & (nv >= MIN_VALID)
        ra = torch.where(span, torch.nan_to_num(r), 0.0).to(acc)
        cnt = nv.clamp(min=1).to(acc)
        mean = ra.sum(1) / cnt
        dev = torch.where(span, ra - mean[:, None], 0.0)
        self.h0 = ((dev * dev).sum(1) / cnt).to(dtype)
        rz = torch.where(span, torch.nan_to_num(r), 0.0)
        r2 = rz * rz
        prev = torch.zeros_like(r2)
        prev[:, 1:] = r2[:, :-1]
        prev = torch.where(t[None] == first[:, None], self.h0[:, None], prev)
        self.r2 = r2.t().contiguous()
        self.prev = prev.t().contiguous()
        self.live = span.t().contiguous()
        self.lo = int(first.min()) if b else 0
        self.hi = int(last.max()) + 1 if b else 0

    def objective(self, rows):
        r2, prev, live = (x[:, rows] for x in (self.r2, self.prev, self.live))
        h0 = self.h0[rows]

        def f(V):
            omega, alpha, beta = to_params(V.to(self.dtype)).unbind(-1)
            h = h0.expand_as(omega)
            nll = torch.zeros(omega.shape, dtype=self.acc,
                              device=omega.device)
            for t in range(self.lo, self.hi):
                hn = omega + alpha * prev[t] + beta * h
                h = torch.where(live[t], hn, h)
                hc = h.clamp(min=FLOOR)
                term = torch.log(2 * math.pi * hc) + r2[t] / hc
                nll += torch.where(live[t], term, 0.0)
            return 0.5 * nll

        return f

    def start(self, rows):
        h0 = self.h0[rows].to(self.acc)
        nat = torch.stack([0.1 * h0.clamp(min=1e-10),
                           torch.full_like(h0, 0.1),
                           torch.full_like(h0, 0.8)], -1)
        return to_free(nat.double()).to(self.acc)


def prepare(rows, dtype, acc):
    return Prepared(rows, dtype, acc)


def _returns(prices: torch.Tensor, dtype) -> torch.Tensor:
    return transforms.difference(transforms.fill_linear(prices.to(dtype)))


def _rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Widest ``|got - ref| / max(1, |ref|)``; infinite where the NaNs do
    not sit at the same places."""
    got = got.to(torch.float64)
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0)).masked_fill(nan, 0)
    return float(err.max()) if err.numel() else 0.0


def _abs_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got = got.to(torch.float64)
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    return float((got - ref).abs().masked_fill(nan, 0).max())


def judge_pipeline(cfg: dict, panel: torch.Tensor, outputs: dict) -> dict:
    """Every row: the returns (relative to max(1, |r|)), both
    autocorrelations (absolute), then the fit on the reference's returns."""
    f64 = torch.float64
    lags = cfg["num_lags"]
    rets, fill_err, acf_err = [], 0.0, 0.0
    for r0 in range(0, panel.shape[0], BLOCK):
        r1 = min(r0 + BLOCK, panel.shape[0])
        ret = _returns(panel[r0:r1], f64)
        fill_err = max(fill_err, _rel_err(outputs["returns"][r0:r1], ret))
        acf_err = max(acf_err,
                      _abs_err(outputs["acf"][r0:r1],
                               transforms.autocorr(ret, lags, f64)),
                      _abs_err(outputs["acf_sq"][r0:r1],
                               transforms.autocorr(ret * ret, lags, f64)))
        rets.append(ret)
    ret = torch.cat(rets)
    del rets
    out = {"fill_err": fill_err, "acf_err": acf_err}
    out.update(_fit.judge(sys.modules[__name__], ret, outputs["fit"],
                          FIT_BLOCK))
    return out


def control_pipeline(cfg: dict, panel: torch.Tensor, dtype) -> dict:
    """The pipeline computed in ``dtype`` (sums in float32)."""
    lags = cfg["num_lags"]
    rets, acf, acf_sq = [], [], []
    for r0 in range(0, panel.shape[0], BLOCK):
        ret = _returns(panel[r0:r0 + BLOCK], dtype)
        acf.append(transforms.autocorr(ret, lags, torch.float32))
        acf_sq.append(transforms.autocorr(ret * ret, lags, torch.float32))
        rets.append(ret)
    ret = torch.cat(rets)
    return {"returns": ret.to(torch.float32), "acf": torch.cat(acf),
            "acf_sq": torch.cat(acf_sq),
            "fit": _fit.control(sys.modules[__name__], ret, dtype,
                                FIT_BLOCK)}

"""Per-model forecast functions for the chunked forecast walk (port of
``forecasting/kernels.py``).

One vocabulary for every fit-capable model family: a **point function**
``(params [B, k], y [B, T]) -> [B, H]`` built on each model module's own
forecast, and a **simulation function** ``(params, y, keys [B, 2]) ->
paths [B, H, S]`` that runs the model's forward recursion with Gaussian
innovations whose scale is estimated from the model's own in-sample
one-step errors — the ``sample`` path bent forward from the end state
instead of from zero.  Interval quantiles over the ``S`` axis are per-row
and per-horizon, so they inherit the row-independence that makes the walk
chunk-layout-invariant.

The reference builds these from its compiled ``_forecast_program``s; the
port calls the models' forecast internals directly, with the alignment
done per row on the device (``align_mode="general"``), so a forecast chunk
never pays a host probe.  On a float32 CUDA panel the point forecasts run
the kernels the models' ``forecast`` functions run: the CSS forward's
``tail`` mode (ARIMA, AR), GARCH's ``last`` mode and the EWMA forward; the
simulations read their in-sample scale and end state from the same kernels
(the CSS forward's ``sum`` and ``tail`` modes, GARCH ``last``, the EWMA
forward) and run the path recursion as plain PyTorch over ``[B, S]``
states.  Holt-Winters runs plain PyTorch on either backend, as its
``forecast`` does.

Innovations are ``_prng.normal`` draws of shape ``(horizon, S)`` per row,
the reference's ``jax.random.normal(key, (horizon, S))``; paths come back
``[B, H, S]`` (the reference's ``[B, S, H]`` transposed), so the quantile
sorts along the last axis.

Model configuration (``model_kwargs``) is normalized to a sorted tuple of
``(key, value)`` pairs with lists coerced to tuples
(:func:`normalize_model_kwargs`): the canonical form is what reaches the
journal config hash, so a live walk and a JSON-round-tripped recovery walk
hash identically.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models import arima as _arima
from ..models import base as _base
from ..models import ewma as _ewma
from ..models import garch as _garch
from ..models import holtwinters as _hw
from ..ops import cuda_kernels as ck
from ..ops.layout import time_major
from . import _prng

__all__ = ["MODELS", "normalize_model_kwargs", "param_width",
           "point_fn", "sim_fn"]

# model name -> allowed config keys (with defaults applied at normalize)
MODELS = {
    "arima": {"order": None, "include_intercept": True},
    "autoregression": {"max_lag": 1},
    "ewma": {},
    "holtwinters": {"period": None, "model_type": "additive"},
    "garch": {},
}


def _norm_val(v):
    if isinstance(v, (list, tuple)):
        return tuple(_norm_val(x) for x in v)
    if isinstance(v, bool):
        return v
    if isinstance(v, float) and float(v).is_integer():
        return int(v)  # JSON round trips can float-ify ints
    return v


def normalize_model_kwargs(model: str, kwargs) -> Tuple:
    """Validated canonical config tuple for ``model`` (see module doc)."""
    if model not in MODELS:
        raise ValueError(
            f"unknown forecast model {model!r} (one of {sorted(MODELS)})")
    allowed = MODELS[model]
    kw = dict(kwargs or ())
    bad = sorted(set(kw) - set(allowed))
    if bad:
        raise ValueError(
            f"forecast model {model!r} does not accept {bad} "
            f"(allowed: {sorted(allowed)})")
    cfg = {}
    for key, default in allowed.items():
        v = _norm_val(kw.get(key, default))
        if v is None:
            raise ValueError(f"forecast model {model!r} requires {key}=")
        cfg[key] = v
    if model == "arima":
        order = tuple(cfg["order"])
        if len(order) == 4:
            raise ValueError(
                "seasonal ARIMA forecasting is not supported yet "
                "(ROADMAP follow-on); pass a plain (p, d, q) order")
        if len(order) != 3:
            raise ValueError(f"bad ARIMA order {cfg['order']!r}")
        order = tuple(int(x) for x in order)
        if min(order) < 0:
            raise ValueError(f"bad ARIMA order {cfg['order']!r}")
        cfg["order"] = order
        cfg["include_intercept"] = bool(cfg["include_intercept"])
    elif model == "autoregression":
        cfg["max_lag"] = int(cfg["max_lag"])
        if cfg["max_lag"] < 1:
            raise ValueError("max_lag must be >= 1")
    elif model == "holtwinters":
        cfg["period"] = int(cfg["period"])
        if cfg["period"] < 2:
            raise ValueError("period must be >= 2")
        if cfg["model_type"] not in ("additive", "multiplicative"):
            raise ValueError(
                f"bad model_type {cfg['model_type']!r}")
    return tuple(sorted(cfg.items()))


def param_width(model: str, cfg: dict) -> int:
    """The params-block width the augmented panel must carry."""
    if model == "arima":
        return _arima._n_params(cfg["order"], cfg["include_intercept"])
    if model == "autoregression":
        return cfg["max_lag"] + 1  # [c, phi_1..phi_p], c = 0 if no intercept
    if model in ("ewma",):
        return 1
    if model in ("holtwinters", "garch"):
        return 3
    raise ValueError(f"unknown forecast model {model!r}")


def _arima_backend(yb, order) -> str:
    p, _, q = order
    return _base.resolve_backend("auto", yb,
                                 structural_ok=ck.css_structural_ok(p, q))


# ---------------------------------------------------------------------------
# point forecasts — each model module's own forecast
# ---------------------------------------------------------------------------


def point_fn(model: str, cfg: dict, horizon: int):
    """``(pb, yb) -> [B, horizon]`` point forecasts (run under
    ``torch.no_grad()``)."""
    if model in ("arima", "autoregression"):
        if model == "arima":
            order, ii = cfg["order"], cfg["include_intercept"]
        else:
            order, ii = (cfg["max_lag"], 0, 0), True
        return lambda pb, yb: _arima._forecast(
            order, horizon, ii, _arima_backend(yb, order), "general",
            pb.contiguous(), yb)
    if model == "ewma":
        return lambda pb, yb: _ewma._forecast(
            pb.contiguous(), yb, horizon, _base.resolve_backend("auto", yb))
    if model == "holtwinters":
        return lambda pb, yb: _hw.forecast(
            pb.contiguous(), yb, cfg["period"], horizon, cfg["model_type"],
            device=yb.device)
    if model == "garch":
        return lambda pb, yb: _garch._forecast(
            pb.contiguous(), yb, horizon, _base.resolve_backend("auto", yb))
    raise ValueError(f"unknown forecast model {model!r}")


# ---------------------------------------------------------------------------
# simulations — forward recursions with Gaussian innovations
# ---------------------------------------------------------------------------


def sim_fn(model: str, cfg: dict, horizon: int, n_samples: int):
    """``(pb, yb, keys [B, 2]) -> paths [B, horizon, S]``.

    Paths simulate the FUTURE OBSERVATIONS under the fitted model with
    innovations of the in-sample one-step error scale — except GARCH,
    whose point forecast is the variance path and whose paths simulate
    future RETURNS (the quantity its interval bands bound).
    """
    if model == "arima":
        return _arima_sim(cfg["order"], cfg["include_intercept"],
                          horizon, n_samples)
    if model == "autoregression":
        return _arima_sim((cfg["max_lag"], 0, 0), True, horizon, n_samples)
    if model == "ewma":
        return _ewma_sim(horizon, n_samples)
    if model == "holtwinters":
        return _hw_sim(cfg["period"],
                       cfg["model_type"] == "multiplicative",
                       horizon, n_samples)
    if model == "garch":
        return _garch_sim(horizon, n_samples)
    raise ValueError(f"unknown forecast model {model!r}")


def _arima_sim(order, include_intercept: bool, horizon: int, n_samples: int):
    p, d, q = order
    i0 = int(include_intercept)

    def f(pb, yb, keys):
        b = yb.shape[0]
        ya, nv0 = _base.align_right(yb)
        yd = _arima._difference(ya, d)
        nvd = nv0 - d
        n = yd.shape[1]
        start = (n - nvd).to(yd.dtype)
        t_idx = torch.arange(n, dtype=yd.dtype, device=yd.device)
        ydz = torch.where(t_idx[None, :] >= start[:, None], yd, 0.0)
        if _arima_backend(yb, order) == "cuda":
            # zb = start (not start + p) is exactly condition=False
            pk = ck.kernel_params(pb, include_intercept).contiguous()
            sse = ck.css_sse_folded(pk, time_major(ydz), start, p, q)
            elast = ck.css_last_errors(p, q, pk, ydz, start).flip(1)
        else:
            e = _arima._css_errors(pb, ydz, order, include_intercept,
                                   condition=False, n_valid=nvd)
            sse = (e * e).sum(-1)
            elast = e.flip(1)[:, :q]
        n_eff = torch.clamp(nvd - p, min=1).to(yb.dtype)
        sigma = torch.sqrt(sse / n_eff)
        ydlast = ydz.flip(1)[:, :p]
        c = pb[:, 0] if include_intercept else yb.new_zeros(b)
        phi = pb[:, i0:i0 + p]
        theta = pb[:, i0 + p:i0 + p + q]
        levels = []
        lv = ya
        for _ in range(d):
            levels.append(lv[:, -1])
            lv = lv[:, 1:] - lv[:, :-1]
        S = n_samples
        eps = sigma[:, None, None] * _prng.normal(keys, (horizon, S))
        ydl = ydlast[:, None, :].expand(b, S, p)
        el = elast[:, None, :].expand(b, S, q)
        lvl = [lv0[:, None].expand(b, S) for lv0 in levels]
        out = []
        for h in range(horizon):
            et = eps[:, h]
            pred = c[:, None]
            if p:
                pred = pred + (ydl * phi[:, None, :]).sum(-1)
            if q:
                pred = pred + (el * theta[:, None, :]).sum(-1)
            ynew = pred + et  # the innovation IS the error at t
            if p:
                ydl = torch.cat([ynew[..., None], ydl[..., :-1]], dim=-1)
            if q:
                el = torch.cat([et[..., None], el[..., :-1]], dim=-1)
            acc = ynew
            for i in reversed(range(d)):  # v_i = lvl[i] + v_{i+1}
                acc = lvl[i] + acc
                lvl[i] = acc
            out.append(acc)
        return torch.stack(out, dim=1)  # [B, H, S]

    return f


def _ewma_sim(horizon: int, n_samples: int):
    def f(pb, yb, keys):
        b, t_len = yb.shape
        a = pb[:, 0].contiguous()
        ya, nv = _base.align_right(yb)
        if _base.resolve_backend("auto", yb) == "cuda":
            xzt, zb = ck.ewma_prefold(ya, nv)
            s = ck.ewma_fwd(xzt, a, zb, "e").t()
        else:
            s = _ewma.smooth(a, ya, nv)
        start = t_len - nv
        err = ya[:, 1:] - s[:, :-1]
        t1 = torch.arange(1, t_len, device=yb.device)
        err = torch.where(t1[None, :] > start[:, None], err, 0.0)
        n_eff = torch.clamp(nv - 1, min=1).to(yb.dtype)
        sigma = torch.sqrt((err * err).sum(-1) / n_eff)
        S = n_samples
        eps = sigma[:, None, None] * _prng.normal(keys, (horizon, S))
        sp = s[:, -1, None].expand(b, S)
        out = []
        for h in range(horizon):
            x = sp + eps[:, h]
            sp = a[:, None] * x + (1.0 - a[:, None]) * sp
            out.append(x)
        paths = torch.stack(out, dim=1)
        return torch.where((nv >= 2)[:, None, None], paths, torch.nan)

    return f


def _hw_sim(period: int, multiplicative: bool, horizon: int,
            n_samples: int):
    def f(pb, yb, keys):
        b, t_len = yb.shape
        ya, nv = _base.align_right(yb)
        preds, (level, trend, seasonal) = _hw._run(
            pb, ya, period, multiplicative, nv)
        start = t_len - nv
        err = ya - preds
        t_idx = torch.arange(t_len, device=yb.device)
        err = torch.where(t_idx[None, :] >= (start + period)[:, None], err,
                          0.0)
        n_eff = torch.clamp(nv - period, min=1).to(yb.dtype)
        sigma = torch.sqrt((err * err).sum(-1) / n_eff)
        alpha, beta, gamma = (pb[:, i, None] for i in range(3))
        S = n_samples
        eps = sigma[:, None, None] * _prng.normal(keys, (horizon, S))
        lv = level[:, None].expand(b, S)
        tr = trend[:, None].expand(b, S)
        # the season as a ring: step h reads slot h mod period and
        # writes it back, the reference's rotating concatenation
        ring = [seasonal[:, k, None].expand(b, S) for k in range(period)]
        out = []
        for h in range(horizon):
            s0 = ring[h % period]
            et = eps[:, h]
            if multiplicative:
                pred = (lv + tr) * s0
                yt = pred + et
                nl = (alpha * yt / torch.clamp(s0, min=1e-12)
                      + (1 - alpha) * (lv + tr))
                ns = (gamma * yt / torch.clamp(nl, min=1e-12)
                      + (1 - gamma) * s0)
            else:
                pred = lv + tr + s0
                yt = pred + et
                nl = alpha * (yt - s0) + (1 - alpha) * (lv + tr)
                ns = gamma * (yt - nl) + (1 - gamma) * s0
            tr = beta * (nl - lv) + (1 - beta) * tr
            lv = nl
            ring[h % period] = ns
            out.append(yt)
        paths = torch.stack(out, dim=1)
        # same structural gate as the point forecast: seeding needs two
        # full seasons
        return torch.where((nv >= 2 * period)[:, None, None], paths,
                           torch.nan)

    return f


def _garch_sim(horizon: int, n_samples: int):
    def f(pb, rb, keys):
        b = rb.shape[0]
        pb = pb.contiguous()
        ra, nv = _base.align_right(rb)
        if _base.resolve_backend("auto", rb) == "cuda":
            rzt, mask, nvf, zb = ck.garch_prefold(ra, nv)
            h0 = ck.garch_h0_folded(rzt, mask, nvf)
            del mask
            h_last = ck.garch_fwd(rzt, pb, h0, zb, "last")
        else:
            h_last = _garch.variances(pb, ra, nv)[:, -1]
        omega, alpha, beta = (pb[:, i, None] for i in range(3))
        S = n_samples
        eps = _prng.normal(keys, (horizon, S))
        hp = h_last[:, None].expand(b, S)
        rp = ra[:, -1, None].expand(b, S)
        out = []
        for h in range(horizon):
            hp = omega + alpha * rp ** 2 + beta * hp
            rp = torch.sqrt(torch.clamp(hp, min=1e-12)) * eps[:, h]
            out.append(rp)
        paths = torch.stack(out, dim=1)
        return torch.where((nv >= 2)[:, None, None], paths, torch.nan)

    return f

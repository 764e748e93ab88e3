"""The port's flagship step: a batched ARIMA(1,1,1) CSS fit on the card.

Counterpart of ``__graft_entry__.entry()``: ``entry()`` returns the fit
step and its example arguments, placed on ``device`` (the card unless the
caller asks for the CPU).  :func:`gen_panel` builds an ARIMA(1,1,1) panel on
the device from a seeded ``torch.Generator``, for panels too large for a
host loop; :func:`gen_garch_prices` builds the volatility pipeline's ragged
price panel and :func:`gen_hourly_panel` the Holt-Winters path's ragged
hourly panel the same way.
"""

from __future__ import annotations

import math

import torch

from .models import arima
from .models.base import to_device

ORDER = (1, 1, 1)
# GARCH(1,1) of the price panel's percent returns: omega, alpha, beta
GARCH_PARAMS = (0.05, 0.08, 0.90)
# share of the price panel's positions that fall in interior gaps
GAP_SHARE = 0.02
# additive Holt-Winters of the hourly panel: alpha, beta, gamma; period.
# The fit's seeds (the first two valid days) carry about one noise unit of
# error per seasonal slot, which pulls the estimated gamma upward; at this
# gamma the pull stays well inside the smoke run's 0.05 bar.
HW_PARAMS = (0.2, 0.01, 0.3)
HW_PERIOD = 24


def gen_panel(batch: int, time: int, seed: int = 0,
              device="cuda") -> torch.Tensor:
    """``[batch, time]`` float32 ARIMA(1,1,1) panel: the ARMA(1,1)
    recursion ``y_t = 0.6 y_{t-1} + e_t + 0.3 e_{t-1}`` on standard-normal
    innovations (the reference's ``__graft_entry__._gen_panel``), integrated
    once.  Built time-major on
    ``device`` (one ``[batch]`` step at a time), then transposed."""
    device = to_device(torch.zeros(0), device).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    e = torch.randn(time, batch, generator=gen, device=device)
    y = torch.empty_like(e)
    y[0] = e[0]
    for t in range(1, time):
        y[t] = 0.6 * y[t - 1] + e[t] + 0.3 * e[t - 1]
    del e
    torch.cumsum(y, dim=0, out=y)
    return y.t().contiguous()


def entry(device="cuda"):
    """-> ``(fit_step, example_args)``: the production fit (alignment,
    Hannan-Rissanen init, batched L-BFGS; the CUDA kernels on a float32
    CUDA panel) on a 64 x 128 example panel."""

    def fit_step(y):
        return arima.fit(y, ORDER, max_iters=20, tol=1e-4, device=device)

    return fit_step, (gen_panel(64, 128, device=device),)


def gen_garch_prices(batch: int, time: int, seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """``[batch, time]`` float32 log prices: daily closes whose percent
    log returns follow GARCH(1,1) with :data:`GARCH_PARAMS` (started at the
    unconditional variance), priced from 100; ``log p_t = log 100 +
    cumsum(r)_t / 100``.

    Missing data, as a daily equity panel has it: up to half of the rows
    list late (a leading NaN run of 1 .. time/2 days), about
    :data:`GAP_SHARE` of the positions fall in interior gaps of 1-5 days
    (holidays, halts), and about 1 % of the rows delist early (a trailing
    NaN run).  Built
    time-major on ``device`` from a seeded ``torch.Generator``, then
    transposed."""
    device = to_device(torch.zeros(0), device).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    omega, alpha, beta = GARCH_PARAMS
    r = torch.randn(time, batch, generator=gen, device=device)
    h = torch.full((batch,), omega / (1.0 - alpha - beta), device=device)
    r_prev = torch.zeros(batch, device=device)
    for t in range(time):  # r[t] <- sqrt(h_t) z_t in place
        h = omega + alpha * r_prev * r_prev + beta * h
        r_prev = r[t].mul_(torch.sqrt(h))
    logp = torch.cumsum(r, dim=0).div_(100.0).add_(math.log(100.0))
    del r
    u = lambda: torch.rand(batch, generator=gen, device=device)  # noqa: E731
    start = torch.where(u() < 0.5, torch.randint(
        1, max(time // 2, 2), (batch,), generator=gen, device=device), 0)
    end = torch.where(u() < 0.01, torch.randint(
        time // 2, time, (batch,), generator=gen, device=device), time)
    t_idx = torch.arange(time, device=device)[:, None]
    logp.masked_fill_((t_idx < start[None, :]) | (t_idx >= end[None, :]),
                      float("nan"))
    # interior gaps: runs of 1-5 days from ~GAP_SHARE/3 of the positions
    opens = torch.rand(time, batch, generator=gen, device=device) \
        < GAP_SHARE / 3.0
    length = torch.randint(1, 6, (time, batch), generator=gen, device=device,
                           dtype=torch.int8)
    for k in range(5):
        run = opens[:time - k] & (length[:time - k] > k)
        logp[k:].masked_fill_(run, float("nan"))
    return logp.t().contiguous()


def gen_hourly_panel(batch: int, time: int, seed: int = 0,
                     device="cuda") -> torch.Tensor:
    """``[batch, time]`` float32 hourly panel drawn from the additive
    Holt-Winters model itself, period :data:`HW_PERIOD`, parameters
    :data:`HW_PARAMS`: ``y_t = L + T + S_t + eps_t`` with unit-normal
    ``eps``, then the fit's level, trend and seasonal updates.

    Per row: level in [400, 600), trend in [-0.02, 0.02) per hour, a daily
    sine profile of amplitude in [10, 50) and random phase, so every value
    stays positive (the multiplicative fit needs that; checked, raising
    otherwise).  Ragged like M4's hourly series: each row keeps its last
    ``n`` observations, ``n`` drawn in [700/960 time, time] (700-960 at
    time = 960), and the leading ones are NaN.  Built time-major on
    ``device`` from a seeded ``torch.Generator``, then transposed."""
    return _hourly_panel(batch, time, HW_PARAMS, seed, device)


def _hourly_panel(batch: int, time: int, params, seed: int,
                  device) -> torch.Tensor:
    """:func:`gen_hourly_panel` under other generating ``params`` (alpha,
    beta, gamma): the tests hold the estimator's bias at other values."""
    device = to_device(torch.zeros(0), device).device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    alpha, beta, gamma = params
    m = HW_PERIOD
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        batch, generator=gen, device=device)
    level, trend = u(400.0, 600.0), u(-0.02, 0.02)
    amp, phase = u(10.0, 50.0), u(0.0, 2.0 * math.pi)
    hours = torch.arange(m, device=device, dtype=torch.float32)[:, None]
    ring = amp * torch.sin(2.0 * math.pi * hours / m + phase)  # [m, batch]
    y = torch.randn(time, batch, generator=gen, device=device)
    for t in range(time):  # y[t] <- L + T + S + eps in place
        s = ring[t % m]
        yt = y[t].add_(level + trend + s)
        new_level = alpha * (yt - s) + (1.0 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1.0 - beta) * trend
        ring[t % m] = gamma * (yt - new_level) + (1.0 - gamma) * s
        level = new_level
    if not bool((y > 0).all()):
        raise RuntimeError("hourly panel has a non-positive value")
    n = torch.randint(time * 700 // 960, time + 1, (batch,), generator=gen,
                      device=device)
    t_idx = torch.arange(time, device=device)[:, None]
    y.masked_fill_(t_idx < (time - n)[None, :], float("nan"))
    return y.t().contiguous()

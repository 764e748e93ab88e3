"""Daily equity panel for the volatility pipeline: ``[rows, time]`` float32
100 x log prices, built on the device.

Frozen copy of the port's ``entry.gen_garch_prices`` (percent log returns
that follow GARCH(1,1) from the unconditional variance, priced from 100)
with the scaling of ``chip_smoke._ragged_prices``: late listings (a
leading NaN run of 1 .. time/2 days on half of the rows), interior gaps of
1-5 days from about ``gap_share`` of the positions, early delistings (a
trailing NaN run on about 1 % of the rows) and one series never listed
(all NaN).  The generating values come from the configuration file.

One change from the program's generator: the series (returns, listing
spans and gaps) of panel ``index`` are drawn from the configuration's
``series_seeds[index]``, and the seed deals them to the rows in an order
of its own.  A GARCH fit runs until its slowest row converges, and which
row that is, and how long it takes, depends on the draw: panels of fresh
draws took 0.19 or 0.55 s a call on one card, so the seed changed the
work.  Every seed now fits the same fixed draws, each in another order,
and a run goes round all of them, so the cell times as many slow rows as
those draws hold.
"""

import math

import torch


def make(cfg: dict, seed: int, device, index: int = 0) -> torch.Tensor:
    rows, time = cfg["rows"], cfg["time"]
    g = cfg["generating"]
    omega, alpha, beta = g["omega"], g["alpha"], g["beta"]
    gap_share = g["gap_share"]
    gen = torch.Generator(device=device)
    seeds = g["series_seeds"]
    gen.manual_seed(seeds[index % len(seeds)])
    r = torch.randn(time, rows, generator=gen, device=device)
    h = torch.full((rows,), omega / (1.0 - alpha - beta), device=device)
    r_prev = torch.zeros(rows, device=device)
    for t in range(time):  # r[t] <- sqrt(h_t) z_t in place
        h = omega + alpha * r_prev * r_prev + beta * h
        r_prev = r[t].mul_(torch.sqrt(h))
    logp = torch.cumsum(r, dim=0).div_(100.0).add_(math.log(100.0))
    del r

    def u():
        return torch.rand(rows, generator=gen, device=device)

    start = torch.where(u() < 0.5, torch.randint(
        1, max(time // 2, 2), (rows,), generator=gen, device=device), 0)
    end = torch.where(u() < 0.01, torch.randint(
        time // 2, time, (rows,), generator=gen, device=device), time)
    t_idx = torch.arange(time, device=device)[:, None]
    logp.masked_fill_((t_idx < start[None, :]) | (t_idx >= end[None, :]),
                      float("nan"))
    opens = torch.rand(time, rows, generator=gen, device=device) \
        < gap_share / 3.0
    length = torch.randint(1, 6, (time, rows), generator=gen, device=device,
                           dtype=torch.int8)
    for k in range(5):
        run = opens[:time - k] & (length[:time - k] > k)
        logp[k:].masked_fill_(run, float("nan"))
    logp[:, 0] = float("nan")  # the ticker that never listed
    order = torch.Generator(device=device)
    order.manual_seed(seed)
    y = logp.t()[torch.randperm(rows, generator=order, device=device)]
    return y.mul_(100.0)

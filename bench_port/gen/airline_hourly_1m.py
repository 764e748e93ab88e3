"""Hourly panel for the airline model: ``[rows, time]`` float32, built on
the device.

Each row is drawn from the airline process itself,
``(1 - L)(1 - L^s) x_t = w_t`` with ``w = (1 + theta L)(1 + Theta L^s) a``
the expanded MA(s + 1) of seeded normal innovations ``a`` (scale
``sigma``; innovations and ``x`` before the first hour 0), that is ``x_t
= x_{t-1} + x_{t-s} - x_{t-s-1} + w_t``; then a level in [400, 600) and a
daily sine profile of amplitude [10, 50) and random phase are added,
which the two differencings remove.  Each row is then made ragged like
M4's hourly series, as ``hw_additive_hourly_1m`` does: it keeps its last
``n`` observations, ``n`` in [700/960 time, time], and the leading ones
are NaN.  The row lengths are drawn once from the configuration's
``length_seed`` and handed out to the rows in an order drawn from the
seed, so every seed fits the same number of observations.  The
generating values come from the configuration file.
"""

import math

import torch


def make(cfg: dict, seed: int, device, index: int = 0) -> torch.Tensor:
    rows, time, s = cfg["rows"], cfg["time"], cfg["period"]
    g = cfg["generating"]
    th, sth = g["theta"], g["Theta"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(rows, generator=gen,
                                           device=device)

    level, amp = u(*g["level"]), u(*g["amplitude"])
    phase = u(0.0, 2.0 * math.pi)
    a = torch.randn(time, rows, generator=gen, device=device)
    a.mul_(g["sigma"])
    w = a.clone()  # the MA polynomial's product, a term at a time
    w[1:].add_(a[:-1], alpha=th)
    w[s:].add_(a[:-s], alpha=sth)
    w[s + 1:].add_(a[:-s - 1], alpha=th * sth)
    del a
    torch.cumsum(w, dim=0, out=w)  # 1 / (1 - L)
    for t0 in range(s, time, s):  # 1 / (1 - L^s), a season at a time
        t1 = min(t0 + s, time)
        w[t0:t1].add_(w[t0 - s:t1 - s])
    y = w.add_(level)
    for h in range(s):
        y[h::s].add_(amp * torch.sin(2.0 * math.pi * h / s + phase))
    lengths = torch.Generator(device=device)
    lengths.manual_seed(g["length_seed"])
    n = torch.randint(time * 700 // 960, time + 1, (rows,),
                      generator=lengths, device=device)
    n = n[torch.randperm(rows, generator=gen, device=device)]
    t_idx = torch.arange(time, device=device)[:, None]
    y.masked_fill_(t_idx < (time - n)[None, :], float("nan"))
    return y.t().contiguous()

"""Hourly panel for the Holt-Winters fit: ``[rows, time]`` float32, built
on the device.

Frozen copy of the port's ``entry.gen_hourly_panel``: each row is drawn
from the additive Holt-Winters model itself (level in [400, 600), trend in
[-0.02, 0.02) per hour, a daily sine profile of amplitude [10, 50) and
random phase, unit-normal noise), then made ragged like M4's hourly series:
each row keeps its last ``n`` observations, ``n`` in [700/960 time, time],
and the leading ones are NaN.  The generating values come from the
configuration file.

One change from the program's generator: the row lengths are drawn once
from the configuration's ``length_seed`` and handed out to the rows in an
order drawn from the seed, so every seed fits the same number of
observations; the series and the order differ.
"""

import math

import torch


def make(cfg: dict, seed: int, device, index: int = 0) -> torch.Tensor:
    rows, time, m = cfg["rows"], cfg["time"], cfg["period"]
    g = cfg["generating"]
    alpha, beta, gamma = g["alpha"], g["beta"], g["gamma"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand(rows, generator=gen,
                                           device=device)

    level, trend = u(400.0, 600.0), u(-0.02, 0.02)
    amp, phase = u(10.0, 50.0), u(0.0, 2.0 * math.pi)
    hours = torch.arange(m, device=device, dtype=torch.float32)[:, None]
    ring = amp * torch.sin(2.0 * math.pi * hours / m + phase)  # [m, rows]
    y = torch.randn(time, rows, generator=gen, device=device)
    for t in range(time):  # y[t] <- L + T + S + eps in place
        s = ring[t % m]
        yt = y[t].add_(level + trend + s)
        new_level = alpha * (yt - s) + (1.0 - alpha) * (level + trend)
        trend = beta * (new_level - level) + (1.0 - beta) * trend
        ring[t % m] = gamma * (yt - new_level) + (1.0 - gamma) * s
        level = new_level
    if not bool((y > 0).all()):
        raise RuntimeError("hourly panel has a non-positive value")
    lengths = torch.Generator(device=device)
    lengths.manual_seed(g["length_seed"])
    n = torch.randint(time * 700 // 960, time + 1, (rows,),
                      generator=lengths, device=device)
    n = n[torch.randperm(rows, generator=gen, device=device)]
    t_idx = torch.arange(time, device=device)[:, None]
    y.masked_fill_(t_idx < (time - n)[None, :], float("nan"))
    return y.t().contiguous()

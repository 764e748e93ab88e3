"""ARIMA(1,1,1) daily panel: ``[rows, time]`` float32, built on the device.

Frozen copy of the port's ``entry.gen_panel`` (the ARMA(1,1) recursion
``y_t = phi y_{t-1} + e_t + theta e_{t-1}`` on standard-normal innovations,
integrated once), so that the yardstick does not move when the program
does.  The generating values come from the configuration file.
"""

import torch


def make(cfg: dict, seed: int, device, index: int = 0) -> torch.Tensor:
    rows, time = cfg["rows"], cfg["time"]
    phi, theta = cfg["generating"]["phi"], cfg["generating"]["theta"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    e = torch.randn(time, rows, generator=gen, device=device)
    y = torch.empty_like(e)
    y[0] = e[0]
    for t in range(1, time):
        y[t] = phi * y[t - 1] + e[t] + theta * e[t - 1]
    del e
    torch.cumsum(y, dim=0, out=y)
    return y.t().contiguous()

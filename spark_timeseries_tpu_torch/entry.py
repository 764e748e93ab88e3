"""The port's flagship step: a batched ARIMA(1,1,1) CSS fit on the card.

Counterpart of ``__graft_entry__.entry()``: ``entry()`` returns the fit
step and its example arguments, placed on ``device`` (the card unless the
caller asks for the CPU).  :func:`gen_panel` builds an ARIMA(1,1,1) panel on
the device from a seeded ``torch.Generator``, for panels too large for a
host loop.
"""

from __future__ import annotations

import torch

from .models import arima
from .models.base import to_device

ORDER = (1, 1, 1)


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

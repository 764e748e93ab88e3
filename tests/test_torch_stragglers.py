"""Straggler compaction in the port's fit drivers: the objective over the
gathered stragglers gathers their rows once, when it is built, and not at
each of its evaluations (every line-search trial and gradient of the
compacted stage would otherwise re-gather ``[T, cap]`` panel columns).

Each driver's objective builder runs on the CPU for both backends (the
``cuda`` one through its kernels' plain versions); an operator-dispatch
counter sees every advanced-indexing gather.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from spark_timeseries_tpu_torch import entry
from spark_timeseries_tpu_torch.models import arima, base, garch
from spark_timeseries_tpu_torch.models import holtwinters as hw
from spark_timeseries_tpu_torch.utils import optim


class _Gathers(TorchDispatchMode):
    """Counts advanced-indexing gathers (``x[idx]``) dispatched inside."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ == "index":
            self.count += 1
        return func(*args, **(kwargs or {}))


def _arima(backend):
    y = entry.gen_panel(64, 80, seed=1, device="cpu")
    yd, nvd, yt, zb, init, _, n_eff = arima._css_prep(
        y, None, (1, 1, 1), True, backend, "dense")
    fb, straggler = arima._objective(backend, (1, 1, 1), True, yd, nvd, yt,
                                     zb, n_eff)
    return fb, straggler, init


def _garch(backend):
    r = entry.gen_garch_prices(64, 120, seed=2, device="cpu").diff(dim=1)
    ra, nv, u0, n_eff = garch._garch_prep(r, base.align_mode_on_host(r))
    fb, straggler = garch._garch_objective(backend, ra, nv, n_eff)
    return fb, straggler, u0


def _argarch(backend):
    r = entry.gen_garch_prices(64, 120, seed=3, device="cpu").diff(dim=1)
    ya, nv, u0, n_eff = garch._argarch_prep(r, base.align_mode_on_host(r))
    fb, straggler = garch._argarch_objective(backend, ya, nv, n_eff)
    return fb, straggler, u0


def _holtwinters(backend):
    y = entry.gen_hourly_panel(64, 120, seed=4, device="cpu")
    mode = base.align_mode_on_host(y)
    ya, nv = base.maybe_align(y, mode)
    n_err = torch.clamp(nv - 24, min=1).to(ya.dtype)
    fb, straggler = hw._hw_objective(backend, ya, nv, n_err, 24, False, mode)
    return fb, straggler, torch.zeros(64, 3)


@pytest.mark.parametrize("backend", ["eager", "cuda"])
@pytest.mark.parametrize("driver", [_arima, _garch, _argarch, _holtwinters],
                         ids=["arima", "garch", "argarch", "holtwinters"])
def test_straggler_objective_gathers_once(driver, backend):
    fb, straggler, x0 = driver(backend)
    idxc = torch.arange(3, 64, 4)
    with _Gathers() as built:
        sub = straggler(idxc)
    assert built.count > 0
    x = x0[idxc]
    with _Gathers() as evals:
        for _ in range(2):
            f = sub(x)
            f_g, _ = optim._value_and_grad(sub, x)
    assert evals.count == 0
    # the gathered objective is the full one restricted to those rows
    np.testing.assert_allclose(f.detach().numpy(),
                               fb(x0).detach()[idxc].numpy(), rtol=1e-6)
    np.testing.assert_allclose(f_g.numpy(), f.detach().numpy(), rtol=1e-6)

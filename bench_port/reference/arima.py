"""Plain ARIMA(1,1,1) with intercept: the conditional sum of squares.

The series is differenced once; with ``c, phi, theta`` the one-step errors
are ``e_t = yd_t - c - phi yd_{t-1} - theta e_{t-1}`` for ``t >= 1``, with
``e_0 = 0`` (the first step conditions the AR lag).  The objective is the
Gaussian negative log-likelihood with the innovation variance concentrated
out, ``n/2 (log(2 pi CSS / n) + 1)`` over the ``n`` conditioned errors.
Dense panels only: a row with a missing value is not eligible here.  A row
is eligible with at least 12 differenced observations.
"""

import math
import sys

import torch

from . import _fit

K = 3
STEP = 1e-4  # finite-difference step in free space (c, phi, theta)
BLOCK = 131072  # rows a block: a float64 time-major block is ~1 GB
MIN_DIFFS = 12


def to_free(params):
    return params


def to_params(v):
    return v


class Prepared:
    def __init__(self, rows: torch.Tensor, dtype, acc):
        y = rows.to(dtype)
        self.acc = acc
        self.dtype = dtype
        self.eligible = (~torch.isnan(y).any(1)) & (y.shape[1] - 1
                                                    >= MIN_DIFFS)
        self.yd = (y[:, 1:] - y[:, :-1]).t().contiguous()  # [n, b]

    def objective(self, rows):
        yd = self.yd[:, rows]
        n = yd.shape[0]

        def f(V):
            c, phi, theta = V.to(self.dtype).unbind(-1)
            e = torch.zeros_like(c)
            css = torch.zeros(c.shape, dtype=self.acc, device=c.device)
            for t in range(1, n):
                pred = torch.addcmul(c, phi, yd[t - 1])
                pred = torch.addcmul(pred, theta, e)
                e = yd[t] - pred
                css.addcmul_(e, e)
            n_eff = n - 1
            return 0.5 * n_eff * (torch.log(2 * math.pi * css / n_eff) + 1)

        return f

    def start(self, rows):
        yd = self.yd[:, rows].to(self.acc)
        z = torch.zeros_like(yd[0])
        return torch.stack([yd.mean(0), z, z], -1)


def prepare(rows, dtype, acc):
    return Prepared(rows, dtype, acc)


def judge_fit(cfg: dict, panel: torch.Tensor, outputs: dict) -> dict:
    return _fit.judge(sys.modules[__name__], panel, outputs["fit"], BLOCK)


def control_fit(cfg: dict, panel: torch.Tensor, dtype) -> dict:
    return {"fit": _fit.control(sys.modules[__name__], panel, dtype, BLOCK)}

"""Plain Box-Jenkins airline model, ARIMA(0,1,1)(0,1,1)_s without a
constant: the conditional sum of squares.

The model (Box, Jenkins, Reinsel & Ljung, *Time Series Analysis*, Series
G) is ``(1 - L)(1 - L^s) y_t = (1 + theta L)(1 + Theta L^s) a_t``.  Over
each row's valid stretch (its first to its last observation), the series
is differenced at lag 1 and then at lag s, ``w_t = (1 - L)(1 - L^s) y_t``:
``n = len(stretch) - (s + 1)`` values.  With ``(theta, Theta)`` the
one-step errors are

    e_t = w_t - theta e_{t-1} - Theta e_{t-s} - theta Theta e_{t-s-1}

for every differenced step, with the errors before the first one 0.  The
objective is the Gaussian negative log-likelihood with the innovation
variance concentrated out, ``n/2 (log(2 pi CSS / n) + 1)`` over the ``n``
errors.  Free parameters: ``(theta, Theta)`` themselves.  Plain PyTorch,
computed in float64 to judge (in bfloat16 for the control), with TF32
off while it runs.

Where this follows the program's convention rather than a choice of its
own:

- the sign of the MA polynomial, ``(1 + theta L)(1 + Theta L^s)``; R's
  ``arima`` writes it so too;
- the conditioning: an MA model has no AR lag to condition on, so every
  differenced step is an error and the errors before the first are 0 (no
  backcasting, as R's CSS also does not);
- the count ``n`` in the concentrated variance: every differenced step;
- the eligibility rule, the program's gate for this order written out:
  with ``q_full = s + 1`` lags and ``k = 2`` parameters a row needs ``n >=
  q_full + (q_full + 1) + k + 2 = 2s + 7`` (55 at s = 24) and ``n >=
  4 (q + 1) = 8``; a row with a gap inside its stretch is not eligible
  here (the program fills such a gap with zeros, which this model does
  not describe, and the configurations make none).
"""

import contextlib
import math
from types import SimpleNamespace

import torch

from . import _fit

K = 2
STEP = 1e-4  # finite-difference step in free space (theta, Theta)
BLOCK = 131072  # rows a block: a float64 time-major block is ~1 GB


def to_free(params):
    return params


def to_params(v):
    return v


def min_diffs(s: int) -> int:
    """The fewest differenced values an eligible row has at period s."""
    q_full = s + 1
    return max(q_full + (q_full + 1) + K + 2, 4 * (1 + 1))


class Prepared:
    def __init__(self, rows: torch.Tensor, dtype, acc, period: int):
        y = rows.to(dtype)
        self.dtype, self.acc, self.s = dtype, acc, period
        b, T = y.shape
        s = period
        valid = ~torch.isnan(y)
        t = torch.arange(T, device=y.device)
        first = torch.where(valid, t, T).amin(1)
        last = torch.where(valid, t, -1).amax(1)
        inside = (t[None] >= first[:, None]) & (t[None] <= last[:, None])
        gap = (inside & ~valid).any(1)
        n = (last - first + 1).clamp(min=0) - (s + 1)
        self.eligible = ~gap & (n >= min_diffs(s))
        # the stretch moved to end at T - 1, zeros before it
        src = t[None] - ((T - 1) - last)[:, None]
        z = torch.gather(torch.nan_to_num(torch.where(inside, y, 0.0)), 1,
                         src.clamp(min=0, max=T - 1))
        z = torch.where(src >= first[:, None], z, 0.0)
        d = z[:, 1:] - z[:, :-1]
        w = d[:, s:] - d[:, :-s]  # [b, T - s - 1]
        N = w.shape[1]
        start = N - n.clamp(min=0)
        # only differences inside the stretch: zeros before its start
        w = torch.where(torch.arange(N, device=y.device)[None]
                        >= start[:, None], w, 0.0)
        self.w = w.t().contiguous()  # [N, b]
        self.n = n
        self.lo = int(start.clamp(max=N).min()) if b else N

    def objective(self, rows):
        w = self.w[:, rows]
        n = self.n[rows].to(self.acc)
        s, N = self.s, self.w.shape[0]

        def f(V):
            th, sth = V.to(self.dtype).unbind(-1)
            cross = th * sth
            zero = torch.zeros_like(th)
            ring = [zero] * (s + 1)  # ring[j] = e_{t-1-j}
            css = torch.zeros(th.shape, dtype=self.acc, device=th.device)
            for t in range(self.lo, N):
                e = w[t] - th * ring[0] - sth * ring[s - 1] - cross * ring[s]
                css.addcmul_(e, e)
                ring = [e] + ring[:-1]
            return 0.5 * n * (torch.log(2 * math.pi * css / n) + 1)

        return f

    def start(self, rows):
        return torch.zeros(int(rows.sum()), K, dtype=self.acc,
                           device=self.w.device)


def _model(period: int) -> SimpleNamespace:
    """This model at ``period``, in the shape ``_fit`` takes."""
    return SimpleNamespace(
        K=K, STEP=STEP, to_free=to_free, to_params=to_params,
        prepare=lambda rows, dtype, acc: Prepared(rows, dtype, acc, period))


@contextlib.contextmanager
def _no_tf32():
    """Float32 matrix products in full precision (no TF32) while the
    reference runs; the process's settings are restored after."""
    mm, dnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = mm.allow_tf32, dnn.allow_tf32
    mm.allow_tf32 = dnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, dnn.allow_tf32 = saved


def judge_fit(cfg: dict, panel: torch.Tensor, outputs: dict) -> dict:
    with _no_tf32():
        return _fit.judge(_model(cfg["period"]), panel, outputs["fit"],
                          BLOCK)


def control_fit(cfg: dict, panel: torch.Tensor, dtype) -> dict:
    with _no_tf32():
        return {"fit": _fit.control(_model(cfg["period"]), panel, dtype,
                                    BLOCK)}


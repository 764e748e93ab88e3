"""Plain additive Holt-Winters, period m (24 in this configuration).

Over each row's valid span, which starts at its first observation and runs
to the end: level ``L0`` is the mean of the first season, trend ``T0`` the
difference of the second season's mean and ``L0`` over m, seasonal
``S0 = first season - L0``.  From the first observation on, with ``s`` the
seasonal term of the step's slot: ``pred = L + T + s``, ``L' = alpha (y -
s) + (1 - alpha)(L + T)``, ``T' = beta (L' - L) + (1 - beta) T``, ``s' =
gamma (y - L') + (1 - gamma) s``.  The objective is the sum of squared
one-step errors after the first season.  Free parameters: the logits of
``alpha, beta, gamma``.  A row is eligible with two full seasons of data
and no gap after its first observation.
"""

from types import SimpleNamespace

import torch

from . import _fit

K = 3
STEP = 1e-4
BLOCK = 131072


def _logit(p):
    p = p.clamp(1e-12, 1 - 1e-12)
    return torch.log(p) - torch.log1p(-p)


def to_free(params):
    return _logit(params)


def to_params(v):
    return torch.sigmoid(v)


class Prepared:
    def __init__(self, rows: torch.Tensor, dtype, acc, period: int):
        y = rows.to(dtype)
        self.dtype, self.acc, self.m = dtype, acc, period
        b, n = y.shape
        m = period
        valid = ~torch.isnan(y)
        t = torch.arange(n, device=y.device)
        first = torch.where(valid, t, n).amin(1)
        tail = t[None] >= first[:, None]
        self.eligible = ~(tail & ~valid).any(1) & (n - first >= 2 * m)
        yz = torch.nan_to_num(y)
        ar = torch.arange(m, device=y.device)
        s1 = torch.gather(yz, 1, (first[:, None] + ar).clamp(max=n - 1))
        s2 = torch.gather(yz, 1, (first[:, None] + m + ar).clamp(max=n - 1))
        self.l0 = s1.to(acc).mean(1).to(dtype)
        self.t0 = ((s2.to(acc).mean(1) - self.l0.to(acc)) / m).to(dtype)
        s0 = s1 - self.l0[:, None]
        # slot q of the ring holds the seasonal term of the steps t = q mod m
        pos = (ar[None, :] - first[:, None]) % m
        self.s0 = torch.gather(s0, 1, pos).t().contiguous()  # [m, b]
        self.y = yz.t().contiguous()
        self.first = first
        self.lo = int(first.min()) if b else 0

    def objective(self, rows):
        y, s0 = self.y[:, rows], self.s0[:, rows]
        first = self.first[rows]
        l0, t0 = self.l0[rows], self.t0[rows]
        m, n = self.m, self.y.shape[0]

        def f(V):
            a, b, g = to_params(V.to(self.dtype)).unbind(-1)
            oa, ob, og = 1 - a, 1 - b, 1 - g
            lev = l0.expand_as(a)
            tr = t0.expand_as(a)
            ring = [s0[q].expand_as(a) for q in range(m)]
            sse = torch.zeros(a.shape, dtype=self.acc, device=a.device)
            for t in range(self.lo, n):
                live = first <= t
                q = t % m
                s = ring[q]
                lt = lev + tr
                err = y[t] - (lt + s)
                sse += torch.where(first + m <= t, err * err, 0.0)
                nl = a * (y[t] - s) + oa * lt
                nt = b * (nl - lev) + ob * tr
                ns = g * (y[t] - nl) + og * s
                lev = torch.where(live, nl, lev)
                tr = torch.where(live, nt, tr)
                ring[q] = torch.where(live, ns, s)
            return sse

        return f

    def start(self, rows):
        nat = torch.tensor([0.3, 0.1, 0.1], dtype=torch.float64,
                           device=self.y.device)
        return to_free(nat).expand(int(rows.sum()), 3).to(self.acc)


def _model(period: int) -> SimpleNamespace:
    """This model at ``period``, in the shape ``_fit`` takes."""
    return SimpleNamespace(
        K=K, STEP=STEP, to_free=to_free, to_params=to_params,
        prepare=lambda rows, dtype, acc: Prepared(rows, dtype, acc, period))


def judge_fit(cfg: dict, panel: torch.Tensor, outputs: dict) -> dict:
    return _fit.judge(_model(cfg["period"]), panel, outputs["fit"], BLOCK)


def control_fit(cfg: dict, panel: torch.Tensor, dtype) -> dict:
    return {"fit": _fit.control(_model(cfg["period"]), panel, dtype, BLOCK)}

"""Plain fillLinear, lag-1 difference and sample autocorrelation
(spark-timeseries' ``UnivariateTimeSeries.fillLinear``, ``differences``
and ``autocorr``), along the last axis of ``[b, T]`` rows.

``acc`` is the dtype sums are kept in.
"""

import torch


def fill_linear(x: torch.Tensor) -> torch.Tensor:
    """Interior NaN runs filled on the line between their valid
    neighbours; leading and trailing NaNs stay."""
    valid = ~torch.isnan(x)
    n = x.shape[-1]
    t = torch.arange(n, device=x.device)
    prev = torch.cummax(torch.where(valid, t, -1), -1).values
    nxt = torch.cummin(torch.where(valid, t, n).flip(-1), -1).values.flip(-1)
    inside = (prev >= 0) & (nxt < n)
    xv = torch.nan_to_num(x)
    lo = torch.gather(xv, -1, prev.clamp(min=0))
    hi = torch.gather(xv, -1, nxt.clamp(max=n - 1))
    w = (t - prev).to(x.dtype) / (nxt - prev).clamp(min=1).to(x.dtype)
    line = lo + (hi - lo) * w
    return torch.where(valid, x, torch.where(inside, line,
                                             torch.full_like(x, float("nan"))))


def difference(x: torch.Tensor) -> torch.Tensor:
    """``out[t] = x[t] - x[t-1]``, ``out[0]`` NaN."""
    out = torch.full_like(x, float("nan"))
    out[..., 1:] = x[..., 1:] - x[..., :-1]
    return out


def autocorr(x: torch.Tensor, lags: int, acc) -> torch.Tensor:
    """``[b, lags]``: r_k = sum_{t>=k} d_t d_{t-k} / sum_t d_t^2 over the
    valid entries, d the deviation from the valid mean (NaN where a row has
    no variance)."""
    valid = ~torch.isnan(x)
    xa = torch.where(valid, x, 0.0).to(acc)
    n = valid.sum(-1, keepdim=True).clamp(min=1).to(acc)
    mean = xa.sum(-1, keepdim=True) / n
    d = torch.where(valid, (x.to(acc) - mean).to(x.dtype), 0.0)
    da = d.to(acc)
    den = (da * da).sum(-1)
    return torch.stack([(d[..., k:] * d[..., :-k]).to(acc).sum(-1) / den
                        for k in range(1, lags + 1)], -1)

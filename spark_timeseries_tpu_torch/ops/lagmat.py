"""Lag-matrix construction for regressions (port of ``ops/lagmat.py``).

Static slicing only, as in the reference.
"""

from __future__ import annotations

import torch


def lag_mat_trim_both(x: torch.Tensor, max_lag: int,
                      include_original: bool = False) -> torch.Tensor:
    """Trimmed lag matrix: rows are t = max_lag .. n-1.

    Column order: (original x[t] if requested,) x[t-1], x[t-2], ...,
    x[t-max_lag].  Shape ``[n - max_lag, max_lag (+1)]``.
    """
    n = x.shape[0]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < series length {n}")
    cols = []
    if include_original:
        cols.append(x[max_lag:])
    for k in range(1, max_lag + 1):
        cols.append(x[max_lag - k:n - k])
    return torch.stack(cols, dim=1)


def lag_mat_trim_both_2d(x: torch.Tensor, max_lag: int,
                         include_original: bool = False) -> torch.Tensor:
    """Lag matrix for multi-column input ``[n, c]`` -> ``[n - max_lag,
    c * lags]``, lag-major: all columns at lag 1, then all at lag 2, ..."""
    n = x.shape[0]
    if max_lag >= n:
        raise ValueError(f"max_lag {max_lag} must be < series length {n}")
    blocks = []
    if include_original:
        blocks.append(x[max_lag:])
    for k in range(1, max_lag + 1):
        blocks.append(x[max_lag - k:n - k])
    return torch.cat(blocks, dim=1)

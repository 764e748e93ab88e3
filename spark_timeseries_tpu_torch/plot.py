"""Plotting conveniences — the upstream ``EasyPlot`` (port of ``plot.py``).

``ezplot``, ``acfPlot`` and ``pacfPlot`` as matplotlib-backed functions.
The ACF/PACF values come from :mod:`.ops.univariate` on the device (a
tensor's own, or ``device=`` for host data); only the rendering is
host-side, reading tensors through ``.cpu()``.  matplotlib is an optional
dependency: importing this module without it works, and the plot
functions raise a clear error when called.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .models.base import to_device
from .ops import univariate as uv


def _plt():
    try:
        import matplotlib.pyplot as plt

        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("plotting requires matplotlib (not installed)") from e


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _as_2d(values) -> np.ndarray:
    arr = _host(values)
    return arr[None, :] if arr.ndim == 1 else arr


def ezplot(values, index=None, labels: Optional[Sequence] = None, ax=None):
    """Line plot of one series (``[time]``) or several (``[series, time]``).

    Upstream ``EasyPlot.ezplot``.  ``index`` may be a ``DateTimeIndex`` (its
    datetimes become the x axis) or any array of x values.
    """
    plt = _plt()
    arr = _as_2d(values)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 4))
    x = np.arange(arr.shape[1]) if index is None else (
        index.datetimes() if hasattr(index, "datetimes") else _host(index)
    )
    for i, row in enumerate(arr):
        ax.plot(x, row, label=None if labels is None else str(labels[i]))
    if labels is not None:
        ax.legend(loc="best", fontsize="small")
    ax.set_xlabel("time")
    return ax


def _corr_plot(corr: np.ndarray, n: int, title: str, ax):
    """Stem plot with the +-1.96/sqrt(n) white-noise significance band the
    upstream ACF/PACF plots draw."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots(figsize=(8, 3))
    lags = np.arange(1, corr.shape[0] + 1)
    ax.vlines(lags, 0.0, corr)
    ax.plot(lags, corr, "o", markersize=3)
    band = 1.96 / np.sqrt(max(n, 1))
    ax.axhline(0.0, linewidth=0.8)
    ax.axhline(band, linestyle="--", linewidth=0.8)
    ax.axhline(-band, linestyle="--", linewidth=0.8)
    ax.set_xlabel("lag")
    ax.set_title(title)
    return ax


def _series64(values, device) -> torch.Tensor:
    """One series as float64 where it lives (host data on ``device``)."""
    if isinstance(values, torch.Tensor):
        return values.to(torch.float64)
    return to_device(np.asarray(values, dtype=np.float64), device)


def acf_plot(values, max_lag: int, ax=None, device="cuda"):
    """ACF stem plot with significance bands — upstream ``EasyPlot.acfPlot``."""
    x = _series64(values, device)
    corr = _host(uv.autocorr(x, max_lag))
    return _corr_plot(corr, int((~torch.isnan(x)).sum()), "ACF", ax)


def pacf_plot(values, max_lag: int, ax=None, device="cuda"):
    """PACF stem plot with significance bands — upstream ``EasyPlot.pacfPlot``."""
    x = _series64(values, device)
    corr = _host(uv.pacf(x, max_lag))
    return _corr_plot(corr, int((~torch.isnan(x)).sum()), "PACF", ax)

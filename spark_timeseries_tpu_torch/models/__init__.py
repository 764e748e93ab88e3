"""Model families: ARIMA and seasonal ARIMA (with the fused order grid),
AR, regression with AR(1) errors, GARCH and ARGARCH, EWMA, Holt-Winters,
and the batched order search over ARIMA grids (:mod:`.auto`)."""

from . import (arima, auto, autoregression, base, ewma, garch, holtwinters,
               regression_arima)
from .auto import AutoFitResult, auto_fit
from .base import FitResult

__all__ = [
    "arima",
    "auto",
    "autoregression",
    "base",
    "ewma",
    "garch",
    "holtwinters",
    "regression_arima",
    "AutoFitResult",
    "FitResult",
    "auto_fit",
]

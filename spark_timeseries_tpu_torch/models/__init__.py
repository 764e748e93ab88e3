"""Model families: ARIMA and seasonal ARIMA (with the fused order grid),
AR, regression with AR(1) errors, GARCH and ARGARCH, EWMA, Holt-Winters."""

from . import (arima, autoregression, base, ewma, garch, holtwinters,
               regression_arima)
from .base import FitResult

__all__ = ["arima", "autoregression", "base", "ewma", "garch", "holtwinters",
           "regression_arima", "FitResult"]

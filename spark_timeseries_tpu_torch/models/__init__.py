"""Model families (ported: ARIMA non-seasonal, GARCH and ARGARCH, EWMA,
Holt-Winters)."""

from . import arima, base, ewma, garch, holtwinters
from .base import FitResult

__all__ = ["arima", "base", "ewma", "garch", "holtwinters", "FitResult"]

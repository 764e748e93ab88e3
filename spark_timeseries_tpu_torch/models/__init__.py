"""Model families (ported: ARIMA non-seasonal, GARCH and ARGARCH)."""

from . import arima, base, garch
from .base import FitResult

__all__ = ["arima", "base", "garch", "FitResult"]

"""Model families (ported: ARIMA, non-seasonal)."""

from . import arima, base
from .base import FitResult

__all__ = ["arima", "base", "FitResult"]

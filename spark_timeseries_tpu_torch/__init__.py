"""spark_timeseries_tpu_torch: the PyTorch + CUDA port of spark_timeseries_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths and public names.  It runs on an NVIDIA GPU: entry points take
``device="cuda"`` by default and run on the CPU only when asked
(``device="cpu"``).  The ARIMA fit and forecast path, the volatility
pipeline (fill chain -> autocorrelation -> GARCH / ARGARCH fit + forecast)
and the smoothing models (EWMA and Holt-Winters fit + forecast) run eleven
hand-written CUDA kernels (``ops.cuda_kernels``, sources in ``csrc/``), one
for each of the reference's TPU kernels.

Ported so far: ``models.arima`` (non-seasonal fit + forecast),
``models.garch``, ``models.ewma``, ``models.holtwinters``,
``models.base``, ``utils.optim``, ``utils.linalg``,
``ops.layout``, ``ops.univariate`` (all but the spline fill, pacf,
cross-correlation, trims and resampling), ``ops.lagmat``,
``ops.cuda_kernels``, ``reliability.status``.
"""

from . import models, ops, reliability, utils

__all__ = ["models", "ops", "reliability", "utils"]

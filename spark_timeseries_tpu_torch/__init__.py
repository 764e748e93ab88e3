"""spark_timeseries_tpu_torch: the PyTorch + CUDA port of spark_timeseries_tpu.

The JAX package beside it is the reference; this package mirrors its module
paths and public names.  It runs on an NVIDIA GPU: entry points take
``device="cuda"`` by default and run on the CPU only when asked
(``device="cpu"``).  The ARIMA path (plain and seasonal fits, the fused
order grid, forecasts), the volatility pipeline (fill chain ->
autocorrelation -> GARCH / ARGARCH fit + forecast) and the smoothing models
(EWMA and Holt-Winters fit + forecast) run eleven hand-written CUDA kernels
(``ops.cuda_kernels``, sources in ``csrc/``), one for each of the
reference's TPU kernels.

Ported so far: ``models.arima``, ``models.autoregression``,
``models.regression_arima``, ``models.garch``, ``models.ewma``,
``models.holtwinters``, ``models.base``, ``stats``, ``utils.optim``,
``utils.linalg``, ``ops.layout``, ``ops.univariate``, ``ops.lagmat``,
``ops.cuda_kernels``, ``reliability.status``.
"""

from . import models, ops, reliability, stats, utils

__all__ = ["models", "ops", "reliability", "stats", "utils"]

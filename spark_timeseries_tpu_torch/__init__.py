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

The resilient fit path (``reliability.resilient_fit``: sanitize -> fit ->
retry ladder, under the deadline watchdog) wraps any of these fits, and
the telemetry plane (``obs``) records its spans and counters.

Ported so far: ``index``, ``obs``, ``models.arima``,
``models.autoregression``, ``models.regression_arima``, ``models.garch``,
``models.ewma``, ``models.holtwinters``, ``models.base``, ``stats``,
``utils.optim``, ``utils.linalg``, ``utils.compile_cache``, ``ops.layout``,
``ops.univariate``, ``ops.lagmat``, ``ops.cuda_kernels``, and of
``reliability`` ``status``, ``sanitize``, ``runner``, ``watchdog``, the
data-fault half of ``faultinject`` and the allocation-failure classifier
of ``plan``.
"""

from . import index, models, obs, ops, reliability, stats, utils

__all__ = ["index", "models", "obs", "ops", "reliability", "stats", "utils"]

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
retry ladder, under the deadline watchdog) wraps any of these fits, the
journaled chunk walk (``reliability.fit_chunked``) runs them over panels
larger than one fit's working set, and the telemetry plane (``obs``)
records their spans and counters.  On top of the walk sit the batched
order search (``models.auto.auto_fit``) and the forecast walk, ensembles
and backtests (``forecasting``).  ``TimeSeriesPanel`` (``panel``) and the
upstream-shaped ``compat.sparkts`` are the front doors over all of it;
``parallel.mesh`` and ``ops.seqparallel`` split one series' time axis
across a mesh of devices (a card may be listed several times).

Ported so far: ``index``, ``obs``, ``models.arima``, ``models.auto``,
``models.autoregression``, ``models.regression_arima``, ``models.garch``,
``models.ewma``, ``models.holtwinters``, ``models.base``, ``stats``,
``utils.optim``, ``utils.linalg``, ``utils.compile_cache``, ``ops.layout``,
``ops.univariate``, ``ops.lagmat``, ``ops.cuda_kernels``, ``forecasting``
(``walk``, ``kernels``, ``params``, ``ensemble``, ``backtest``,
``augment``), ``reliability`` (``status``, ``sanitize``, ``runner``,
``watchdog``, ``chunked`` with its single- and multi-lane walks,
``journal``, ``committer``, ``prefetcher``, ``source``, ``sink``,
``delta``, ``plan`` and the data, commit, disk, lane, request and server
faults of ``faultinject``), ``panel``, ``compat``, ``plot``,
``parallel.mesh`` (with its gloo process group), ``ops.seqparallel`` and
the in-process half of ``serving`` (``session``, ``admission``,
``batcher``, ``profiles``, ``server``, ``tickloop``).  Still to port: the
wire and fleet half of ``serving`` (``transport``, ``client``,
``health``, ``fleet``) with ``reliability.chaos``.
"""

from . import (compat, forecasting, index, models, obs, ops, parallel,
               reliability, serving, stats, utils)
from .index import (
    BusinessDayFrequency,
    DateTimeIndex,
    DayFrequency,
    DurationFrequency,
    Frequency,
    HourFrequency,
    HybridDateTimeIndex,
    IrregularDateTimeIndex,
    MinuteFrequency,
    MonthFrequency,
    SecondFrequency,
    UniformDateTimeIndex,
    WeekFrequency,
    YearFrequency,
    from_string,
    hybrid,
    irregular,
    uniform,
    uniform_from_interval,
)
from .ops import univariate
from .panel import (TimeSeriesPanel, from_dataframe, from_observations,
                    from_series_dict)
from .parallel import default_mesh

__all__ = [
    "BusinessDayFrequency",
    "DateTimeIndex",
    "DayFrequency",
    "DurationFrequency",
    "Frequency",
    "HourFrequency",
    "HybridDateTimeIndex",
    "IrregularDateTimeIndex",
    "MinuteFrequency",
    "MonthFrequency",
    "SecondFrequency",
    "UniformDateTimeIndex",
    "WeekFrequency",
    "TimeSeriesPanel",
    "YearFrequency",
    "compat",
    "default_mesh",
    "forecasting",
    "from_dataframe",
    "from_observations",
    "from_series_dict",
    "from_string",
    "hybrid",
    "index",
    "irregular",
    "models",
    "obs",
    "ops",
    "parallel",
    "reliability",
    "serving",
    "stats",
    "uniform",
    "uniform_from_interval",
    "univariate",
    "utils",
]

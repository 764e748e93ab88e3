"""Panel-scale forecasting (port of ``forecasting/``): the forecast walk,
rolling-origin backtest campaigns, and criterion-weighted ensembles.

Three layers over the durable chunk driver:

- :mod:`.walk` — ``forecast_chunked``: per-model forecast functions run as
  a chunked walk via an AUGMENTED panel (``[y | params | status | row]``,
  :mod:`.augment`), so journaling, pipelining, prefetch and
  ``ChunkSource`` streaming compose for free and every composition is
  bitwise-identical to the serial in-memory walk.  Fitted params come
  from memory or straight from a fit journal (:mod:`.params` — fit once
  on disk, forecast many).  ``intervals=True`` adds Monte-Carlo quantile
  bands under counter-based threefry keys (:mod:`._prng`) derived from
  the journal fingerprint (bitwise-reproducible).
- :mod:`.backtest` — ``run_backtest``: an expanding-window refit x
  horizon sweep as ONE journaled campaign, per-window walks warm-started
  from the previous window's journaled params, MAE/RMSE/MAPE/coverage
  into a durable ``backtest_manifest.json`` + metrics shards,
  crash-resumable to bitwise-identical metrics.
- :mod:`.ensemble` — ``ensemble_forecast``: softmax criterion weights
  over an auto-fit grid's ``[G, B]`` criteria matrix blend member
  forecasts (point + interval); ``temperature=0`` recovers the argmin
  winner bitwise.

On the card the point forecasts run the CSS, GARCH and EWMA kernels; the
path simulations run plain PyTorch over ``[B, S]`` states.
"""

from . import augment, backtest, ensemble, kernels, params, walk
from .augment import (ColumnBlockSource, augmented_host, augmented_panel,
                      derive_status)
from .backtest import (BACKTEST_MANIFEST, BacktestResult,
                       StaleBacktestError, default_origins, run_backtest)
from .ensemble import (EnsembleForecast, criterion_weights,
                       ensemble_forecast)
from .params import load_auto_members, load_fit_result
from .walk import (ForecastResult, as_result, forecast_chunked,
                   forecast_fit, split_forecast, warmstart_fit)

__all__ = [
    "BACKTEST_MANIFEST",
    "BacktestResult",
    "ColumnBlockSource",
    "EnsembleForecast",
    "ForecastResult",
    "StaleBacktestError",
    "as_result",
    "augment",
    "augmented_host",
    "augmented_panel",
    "backtest",
    "criterion_weights",
    "default_origins",
    "derive_status",
    "ensemble",
    "ensemble_forecast",
    "forecast_chunked",
    "forecast_fit",
    "kernels",
    "load_auto_members",
    "load_fit_result",
    "params",
    "run_backtest",
    "split_forecast",
    "walk",
    "warmstart_fit",
]

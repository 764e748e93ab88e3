"""``sparkts``-shaped API on the PyTorch port (port of
``compat/sparkts.py``).

Mirrors the upstream Python package (``sparkts``: ``timeseriesrdd.py``,
``datetimeindex.py``, ``models/``) as thin host-side shims over the
batched device code: the "RDD" is a
:class:`~spark_timeseries_tpu_torch.panel.TimeSeriesPanel`, ``map_series``
is one ``torch.vmap`` over the keys axis, and model fits run the whole
collection at once (on the card, through the port's CUDA kernels).

Intentional deltas from upstream, as in the reference:
- no SparkContext / SQLContext arguments anywhere;
- ``map_series`` prefers a PyTorch ``[time] -> [time']`` function (one
  ``torch.vmap``); pandas-Series lambdas — the upstream contract — run
  through ``mode="host"`` (or the ``mode="auto"`` fallback) at
  Python-loop speed;
- model wrappers hold parameter tensors and work on batches too.

And of the port: host data becomes tensors on ``device=`` (default
``"cuda"``, as every entry point of the port; a tensor stays where it
is), a model's methods run where its parameters live, and the samplers
take an integer seed.  pandas and pyarrow are imported only by the
functions that need them.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import index as dtix
from .. import obs
from .. import panel as panellib
from ..index import DateTimeIndex
from ..models import arima as _arima
from ..models import autoregression as _ar
from ..models import ewma as _ewma
from ..models import garch as _garch
from ..models import holtwinters as _hw
from ..models import regression_arima as _regarima
from ..models.base import to_device
from ..panel import TimeSeriesPanel
from ..stats import tests as _stats

# ---------------------------------------------------------------------------
# datetimeindex.py surface
# ---------------------------------------------------------------------------

uniform = dtix.uniform
irregular = dtix.irregular
hybrid = dtix.hybrid

BusinessDayFrequency = dtix.BusinessDayFrequency
DayFrequency = dtix.DayFrequency
HourFrequency = dtix.HourFrequency
MinuteFrequency = dtix.MinuteFrequency
SecondFrequency = dtix.SecondFrequency
MonthFrequency = dtix.MonthFrequency
YearFrequency = dtix.YearFrequency
WeekFrequency = dtix.WeekFrequency

from_string = dtix.from_string
uniform_from_interval = dtix.uniform_from_interval


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# What torch.vmap raises for a function it cannot batch (data-dependent
# Python control flow, ``.item()``, a host conversion of a batched
# tensor), read off the message so that nothing else raising RuntimeError
# — a kernel's own failure among them — is taken for it.
_VMAP_REFUSALS = ("vmap:", "Cannot access data pointer of Tensor that "
                  "doesn't have storage")


def _vmap_refused(e: Exception) -> bool:
    if isinstance(e, (TypeError, AttributeError, NotImplementedError)):
        return True  # the reference's three
    return isinstance(e, RuntimeError) and str(e).startswith(_VMAP_REFUSALS)


# ---------------------------------------------------------------------------
# timeseriesrdd.py surface
# ---------------------------------------------------------------------------


class TimeSeriesRDD:
    """Upstream ``sparkts.timeseriesrdd.TimeSeriesRDD``, panel-backed.

    One tensor replaces the distributed ``RDD[(K, Vector)]``; the method
    names and semantics follow the upstream Python wrapper.
    """

    def __init__(self, panel: TimeSeriesPanel):
        self.panel = panel

    # -- index / keys ----------------------------------------------------

    @property
    def index(self) -> DateTimeIndex:
        return self.panel.index

    def keys(self):
        return list(self.panel.keys)

    def count(self) -> int:
        return self.panel.n_series

    # -- transforms ------------------------------------------------------

    def map_series(self, fn: Callable, dt_index: Optional[DateTimeIndex] = None,
                   mode: str = "auto") -> "TimeSeriesRDD":
        """Apply ``fn`` to every series.

        ``mode="device"``: ``fn`` is a PyTorch ``[time] -> [time']``
        function, run as one ``torch.vmap`` over the panel (the fast path).
        ``mode="host"``: ``fn`` takes and returns a pandas Series (the
        upstream Python contract) and runs in a host loop — complete
        parity, Python-loop speed.  ``mode="auto"`` tries the device path
        and falls back to host with a warning only when ``torch.vmap``
        cannot batch ``fn`` (``TypeError``, ``AttributeError``,
        ``NotImplementedError``, or vmap's own ``RuntimeError``); any other
        error propagates rather than masquerading as "not batchable".
        """
        if mode not in ("auto", "device", "host"):
            raise ValueError(f"mode must be auto|device|host, got {mode!r}")
        if mode != "host":
            try:
                return TimeSeriesRDD(self.panel.map_series(fn, dt_index))
            except (TypeError, AttributeError, NotImplementedError,
                    RuntimeError) as e:
                if mode == "device" or not _vmap_refused(e):
                    raise
                import warnings

                warnings.warn(
                    "map_series: fn cannot be batched by torch.vmap; falling "
                    "back to the host (pandas) path. Pass mode='host' to "
                    "silence or mode='device' to raise.",
                    stacklevel=2,
                )
        return self._map_series_host(fn, dt_index)

    def _map_series_host(self, fn: Callable, dt_index: Optional[DateTimeIndex]
                         ) -> "TimeSeriesRDD":
        import pandas as pd

        idx = self.panel.index
        out_index = dt_index if dt_index is not None else idx
        dts = pd.DatetimeIndex(idx.datetimes())
        vals = _host(self.panel.series_values())
        rows = [
            np.asarray(fn(pd.Series(row, index=dts)), dtype=vals.dtype)
            for row in vals
        ]
        out = np.stack(rows) if rows else vals[:0]
        if out.shape[1] != out_index.size:
            raise ValueError(
                f"host map_series output length {out.shape[1]} does not match "
                f"index size {out_index.size}; pass dt_index= for "
                "length-changing transforms"
            )
        return TimeSeriesRDD(
            panellib.TimeSeriesPanel(
                out_index, list(self.panel.keys), out, mesh=self.panel.mesh,
                device=self.panel.values.device,
            )
        )

    def fill(self, method: str) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.fill(method))

    def differences(self, n: int = 1) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.differences(n))

    def quotients(self, n: int = 1) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.quotients(n))

    def return_rates(self) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.return_rates())

    def slice(self, start, end) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.slice(start, end))

    def with_index(self, new_index: DateTimeIndex) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.with_index(new_index))

    def remove_instants_with_nans(self) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.remove_instants_with_nans())

    def filter(self, predicate) -> "TimeSeriesRDD":
        return TimeSeriesRDD(self.panel.filter_keys(predicate))

    def find_series(self, key):
        """``[time]`` numpy values for one key (upstream returns a pandas
        Series; use :meth:`to_pandas` for that)."""
        return _host(self.panel[key])

    # -- exits -----------------------------------------------------------

    def collect(self):
        """List of ``(key, np.ndarray[time])`` pairs."""
        vals = _host(self.panel.series_values())
        return list(zip(self.keys(), vals))

    def to_instants(self):
        dts, vals = self.panel.to_instants()
        vals = _host(vals)
        return [(dts[i], vals[i]) for i in range(len(dts))]

    def to_instants_dataframe(self):
        return self.panel.to_instants_dataframe()

    def to_row_matrix(self):
        """``[time, n_series]`` numpy matrix (upstream ``toRowMatrix``)."""
        return _host(self.panel.to_row_matrix())

    def to_indexed_row_matrix(self):
        """``[(loc, row[n_series])]`` pairs (upstream ``toIndexedRowMatrix``)."""
        locs, vals = self.panel.to_indexed_row_matrix()
        vals = _host(vals)
        return [(int(locs[i]), vals[i]) for i in range(len(locs))]

    def to_observations_dataframe(self, ts_col="timestamp", key_col="key",
                                  value_col="value"):
        return self.panel.to_observations_dataframe(ts_col, key_col, value_col)

    def to_pandas(self):
        return self.panel.to_pandas()

    def series_stats(self):
        return self.panel.series_stats()

    def save_as_csv(self, path: str) -> None:
        self.panel.save_csv(path)

    def save_as_parquet_data_frame(self, path: str) -> None:
        """Upstream ``saveAsParquetDataFrame`` analog (series-major Parquet —
        see ``TimeSeriesPanel.save_parquet`` for the layout rationale)."""
        self.panel.save_parquet(path)

    def __len__(self) -> int:
        return self.panel.n_series


def time_series_rdd_from_observations(dt_index: DateTimeIndex, df,
                                      ts_col: str, key_col: str,
                                      val_col: str,
                                      device="cuda") -> TimeSeriesRDD:
    """Upstream constructor signature, DataFrame-in, panel-backed-out."""
    return TimeSeriesRDD(
        panellib.from_dataframe(
            df, dt_index, ts_col=ts_col, key_col=key_col, value_col=val_col,
            device=device,
        )
    )


def time_series_rdd_from_parquet(path: str, device="cuda") -> TimeSeriesRDD:
    """Upstream ``timeSeriesRDDFromParquet`` analog."""
    return TimeSeriesRDD(TimeSeriesPanel.load_parquet(path, device=device))


def time_series_rdd_from_pandas_dataframe(dt_index: DateTimeIndex, df,
                                          device="cuda") -> TimeSeriesRDD:
    """Wide pandas frame (columns = keys, rows aligned to ``dt_index``)."""
    return TimeSeriesRDD(
        TimeSeriesPanel(dt_index, list(df.columns), df.to_numpy().T,
                        device=device)
    )


# ---------------------------------------------------------------------------
# models/ surface — Model.fit_model(...) classmethods returning model objects
# ---------------------------------------------------------------------------


def _require_checkpoint_dir(durable_kwargs: dict) -> None:
    """The durability knobs only act through the journaled chunk driver;
    accepting them on the plain path would silently drop an SLO the caller
    believes is armed (and swallow typos)."""
    if durable_kwargs:
        raise TypeError(
            f"{sorted(durable_kwargs)} require checkpoint_dir= (they "
            "configure the journaled chunk driver; without a journal the "
            "plain fit path would silently ignore them)")


def _durable_fit(fit_fn, ts, checkpoint_dir, *, device="cuda",
                 chunk_rows=None, chunk_budget_s=None, job_budget_s=None,
                 resume="auto", pipeline=True, pipeline_depth=2,
                 prefetch_depth=1, align_mode=None, shard=False, mesh=None):
    """Route a compat fit through the journaled chunk driver
    (``reliability.fit_chunked``, ``resilient=False``): every finished
    chunk is committed to a write-ahead journal and a restarted call with
    the same data/config skips committed chunks (results bitwise-identical
    to an uninterrupted run).  ``fit_fn`` is a keyword-bound partial of the
    model-module fit, so the journal's config hash covers the
    hyperparameters.  Returns the ``[batch?, k]`` params with single-series
    inputs debatched, like the plain path.

    ``ts`` may be a tensor (walked where it lives), a host array (moved to
    ``device``), or a ``reliability.ChunkSource`` / npz shard-directory
    path: the walk then stages each chunk to ``device`` through the
    source's pinned buffers.  ``shard=True`` / ``mesh=`` run the
    multi-lane walk of ``fit_chunked``.
    """
    import os as _os

    from .. import reliability as rel

    if isinstance(ts, (rel.ChunkSource, str, _os.PathLike)):
        single = False  # sources are 2-D panels by construction
        yb = rel.as_source(ts)
    else:
        a = ts if isinstance(ts, torch.Tensor) else to_device(ts, device)
        single = a.ndim == 1
        yb = a[None, :] if single else a
    res = rel.fit_chunked(
        fit_fn, yb, chunk_rows=chunk_rows, resilient=False,
        checkpoint_dir=checkpoint_dir, resume=resume,
        chunk_budget_s=chunk_budget_s, job_budget_s=job_budget_s,
        pipeline=pipeline, pipeline_depth=pipeline_depth,
        prefetch_depth=prefetch_depth, align_mode=align_mode,
        shard=shard, mesh=mesh, device=device,
    )
    params = res.params
    if not isinstance(params, torch.Tensor):
        params = torch.as_tensor(np.asarray(params))
    return params[0] if single else params


def _device_of(ts, device):
    """Where a fit of ``ts`` runs: a tensor's own device, else ``device``."""
    return panellib._device_kw(ts) or device


class _ModelBase:
    """Parameters as a tensor (host ones moved to ``device``, default
    ``"cuda"``); methods run where the parameters live."""

    def __init__(self, params, device="cuda"):
        self.params = (params if isinstance(params, torch.Tensor)
                       else to_device(params, device))

    @property
    def coefficients(self) -> np.ndarray:
        return _host(self.params)

    @property
    def _device(self):
        return self.params.device

    # -- panel forecasting -----------------------------------------------
    # Subclasses that map onto a forecast-capable model family override
    # ``_forecast_spec`` and inherit the durable panel wrapper: the
    # chunked forecast walk over a WHOLE panel of series sharing this
    # model's per-row params (``forecasting.forecast_chunked``).

    def _forecast_spec(self):
        raise NotImplementedError(
            f"{type(self).__name__} has no panel forecast kernel yet")

    def forecast_panel(self, ts, n_future: int, **walk_kwargs):
        """Chunked panel forecast: ``ts [rows, T]`` (tensor, array, source,
        or npz shard dir), one row of ``self.params`` per series (a single
        shared param vector is broadcast).  Returns a
        ``forecasting.ForecastResult``; ``checkpoint_dir=`` /
        ``intervals=`` / ``device=`` etc. ride through to
        ``forecasting.forecast_chunked`` (by default the walk runs where
        the parameters live)."""
        import os as _os

        from .. import forecasting as _forecasting
        from .. import reliability as rel

        if isinstance(ts, (rel.ChunkSource, str, _os.PathLike)):
            yb = rel.as_source(ts)
        else:
            yb = ts if isinstance(ts, torch.Tensor) else to_device(
                ts, walk_kwargs.get("device", self._device))
            yb = yb[None, :] if yb.ndim == 1 else yb
        rows = int(yb.shape[0])
        params = np.atleast_2d(_host(self.params))
        if params.shape[0] == 1 and rows > 1:
            params = np.repeat(params, rows, axis=0)
        model, model_kwargs = self._forecast_spec()
        walk_kwargs.setdefault("device", self._device)
        with obs.span("compat.forecast_panel", model=model):
            return _forecasting.forecast_chunked(
                model, params, yb, n_future, model_kwargs=model_kwargs,
                **walk_kwargs)

    # -- persistence -----------------------------------------------------
    # The reference's fitted models are plain serializable case classes;
    # here the analog is an ``.npz`` holding the parameter vector plus each
    # class's hyperparameters, the reference's file layout.

    def _meta(self) -> dict:
        return {}

    @classmethod
    def _from_saved(cls, params, meta: dict) -> "_ModelBase":
        return cls(params)

    def save(self, path: str) -> None:
        np.savez(_npz_path(path), _class=type(self).__name__,
                 params=_host(self.params), **self._meta())

    @classmethod
    def load(cls, path: str, device="cuda") -> "_ModelBase":
        model = load_model(path, device=device)
        if type(model) is not cls:
            raise ValueError(
                f"{path!r} holds a {type(model).__name__}, not a {cls.__name__}"
            )
        return model


def _npz_path(path: str) -> str:
    # np.savez silently appends ".npz"; normalize so save/load agree
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def load_model(path: str, device="cuda") -> "_ModelBase":
    """Load any saved model (of either package), dispatching on the class
    recorded in the file; its parameters go to ``device``."""
    with np.load(_npz_path(path)) as z:
        name = str(z["_class"])
        klass = globals().get(name)
        if klass is None or not (isinstance(klass, type)
                                 and issubclass(klass, _ModelBase)):
            raise ValueError(f"{path!r} holds unknown model class {name!r}")
        meta = {k: z[k] for k in z.files if k not in ("_class", "params")}
        return klass._from_saved(to_device(z["params"], device), meta)


def _series(ts, dev) -> torch.Tensor:
    return ts if isinstance(ts, torch.Tensor) else to_device(ts, dev)


class ARIMAModel(_ModelBase):
    def __init__(self, p, d, q, params, has_intercept=True, device="cuda"):
        super().__init__(params, device)
        self.p, self.d, self.q = p, d, q
        self.has_intercept = has_intercept

    @property
    def order(self):
        return (self.p, self.d, self.q)

    def _meta(self) -> dict:
        return dict(p=self.p, d=self.d, q=self.q, has_intercept=self.has_intercept)

    @classmethod
    def _from_saved(cls, params, meta):
        return cls(int(meta["p"]), int(meta["d"]), int(meta["q"]), params,
                   bool(meta["has_intercept"]))

    def forecast(self, ts, n_future: int):
        return _host(_arima.forecast(self.params, _series(ts, self._device),
                                     self.order, n_future,
                                     self.has_intercept, device=self._device))

    def _forecast_spec(self):
        return "arima", {"order": self.order,
                         "include_intercept": self.has_intercept}

    def sample(self, n: int, seed: int = 0):
        return _host(_arima.sample(self.params, seed, n, self.order,
                                   self.has_intercept, device=self._device))

    def _css(self, ts):
        y = _series(ts, self._device).to(self._device)
        yd = _arima._difference(y[None, :], self.d)
        pb = self.params.to(yd.dtype)[None, :]
        return _arima.css_neg_loglik(pb, yd, self.order, self.has_intercept)[0]

    def log_likelihood_css(self, ts) -> float:
        return -float(self._css(ts))

    def approx_aic(self, ts) -> float:
        k = _arima._n_params(self.order, self.has_intercept)
        return float(2.0 * self._css(ts) + 2.0 * k)

    def add_time_dependent_effects(self, ts):
        return _host(_arima.add_time_dependent_effects(
            self.params, _series(ts, self._device), self.order,
            self.has_intercept, device=self._device))

    def remove_time_dependent_effects(self, ts):
        return _host(_arima.remove_time_dependent_effects(
            self.params, _series(ts, self._device), self.order,
            self.has_intercept, device=self._device))

    def is_stationary(self):
        return bool(np.all(_arima.is_stationary(self.params, self.order,
                                                self.has_intercept)))

    def is_invertible(self):
        return bool(np.all(_arima.is_invertible(self.params, self.order,
                                                self.has_intercept)))


class SeasonalARIMAModel(_ModelBase):
    """A seasonal SARIMA winner from :meth:`ARIMA.auto_fit`.

    Holds the selected order, seasonal spec, and fitted parameters
    (layout ``[c?, phi, theta, PHI, THETA]`` — ``models.arima.
    _split_params_seasonal``).  Deliberately NOT an :class:`ARIMAModel`:
    that class's forecast/sample/effects methods split params with the
    non-seasonal layout and difference only ``d`` times, which would
    silently drop the seasonal structure the criterion selected the model
    for.  Until seasonal forecasting lands these methods raise instead of
    returning wrong numbers.
    """

    def __init__(self, order, seasonal, params, has_intercept=True,
                 device="cuda"):
        super().__init__(params, device)
        self.order = tuple(int(v) for v in order)
        self.seasonal = tuple(int(v) for v in seasonal)
        self.has_intercept = has_intercept

    def _meta(self) -> dict:
        return dict(order=np.asarray(self.order),
                    seasonal=np.asarray(self.seasonal),
                    has_intercept=self.has_intercept)

    @classmethod
    def _from_saved(cls, params, meta):
        return cls([int(v) for v in meta["order"]],
                   [int(v) for v in meta["seasonal"]], params,
                   bool(meta["has_intercept"]))

    def _not_implemented(self, what: str):
        raise NotImplementedError(
            f"{what} is not implemented for seasonal models yet "
            f"(order {self.order} x {self.seasonal}); the fitted "
            "parameters and the selection criterion are available on "
            ".params / .criterion_value")

    def forecast(self, ts, n_future: int):
        self._not_implemented("forecast")

    def sample(self, n: int, seed: int = 0):
        self._not_implemented("sample")

    def add_time_dependent_effects(self, ts):
        self._not_implemented("add_time_dependent_effects")

    def remove_time_dependent_effects(self, ts):
        self._not_implemented("remove_time_dependent_effects")

    def log_likelihood_css(self, ts) -> float:
        """Concentrated seasonal CSS log-likelihood of ``ts`` under the
        fitted parameters (both differencings applied)."""
        from ..models.arima import (_difference, _difference_seasonal,
                                    sarima_neg_loglik)

        P, D, Q, s = self.seasonal
        yd = to_device(np.asarray(_host(ts), np.float64), self._device)
        yd = _difference(yd, self.order[1])
        yd = _difference_seasonal(yd, D, s)
        return -float(sarima_neg_loglik(
            self.params.to(yd.dtype)[None, :], yd[None, :], self.order,
            self.seasonal, self.has_intercept)[0])


class ARIMA:
    @staticmethod
    def fit_model(p: int, d: int, q: int, ts, include_intercept: bool = True,
                  method: str = "css-cgd", user_init_params=None,
                  checkpoint_dir: Optional[str] = None,
                  align_mode: Optional[str] = None, device="cuda",
                  **durable_kwargs) -> ARIMAModel:
        """``checkpoint_dir=`` journals the fit for crash/preemption resume
        (``reliability.fit_chunked``); ``chunk_rows`` / ``chunk_budget_s``
        / ``job_budget_s`` / ``resume`` / ``pipeline`` /
        ``pipeline_depth`` / ``prefetch_depth`` ride along to the chunk
        driver.  ``align_mode=`` is the static alignment hint
        (``models.base.resolve_align_mode``) — valid with or without a
        journal.  A tensor ``ts`` is fitted where it lives, host data on
        ``device``."""
        dev = _device_of(ts, device)
        with obs.span("compat.fit_model", model="ARIMA"):
            if checkpoint_dir is not None:
                import functools

                params = _durable_fit(
                    functools.partial(_arima.fit, order=(p, d, q),
                                      include_intercept=include_intercept,
                                      method=method,
                                      init_params=user_init_params),
                    ts, checkpoint_dir, align_mode=align_mode, device=dev,
                    **durable_kwargs)
                return ARIMAModel(p, d, q, params, include_intercept)
            _require_checkpoint_dir(durable_kwargs)
            res = _arima.fit(ts, (p, d, q), include_intercept,
                             method=method, init_params=user_init_params,
                             align_mode=align_mode, device=dev)
            return ARIMAModel(p, d, q, res.params, include_intercept)

    @staticmethod
    def auto_fit(ts, orders=None, criterion: str = "aicc",
                 include_intercept: bool = True,
                 checkpoint_dir: Optional[str] = None,
                 **auto_kwargs):
        """Batched order search (``models.auto.auto_fit``): fit a grid of
        candidate ``(p, d, q)`` (optionally seasonal
        ``(p, d, q, (P, D, Q, s))``) orders and select per series by
        ``criterion`` (AICc default; AIC/BIC).

        The whole grid is fitted through the journaled chunk driver
        (``checkpoint_dir=`` makes the search durable; every other
        ``auto_fit`` knob — ``stage2``, ``chunk_rows``, budgets,
        ``device`` — rides through).

        Returns a single model of the winning order for a ``[time]``
        series, or a list of per-series models (``None`` where no
        candidate produced a finite criterion) for a ``[batch, time]``
        panel: an :class:`ARIMAModel` for non-seasonal winners, a
        :class:`SeasonalARIMAModel` for seasonal ones.  The underlying
        ``AutoFitResult`` rides on each model as ``model.auto_result``.
        """
        from ..models import auto as _auto

        with obs.span("compat.auto_fit", model="ARIMA"):
            dev = _device_of(ts, auto_kwargs.get("device", "cuda"))
            auto_kwargs["device"] = dev
            a = _series(ts, dev)
            single = a.ndim == 1
            res = _auto.auto_fit(
                a[None, :] if single else a, orders, criterion=criterion,
                include_intercept=include_intercept,
                checkpoint_dir=checkpoint_dir, **auto_kwargs)
            params = torch.as_tensor(np.asarray(res.params), device=dev)
            models = []
            for i, g in enumerate(np.asarray(res.order_index)):
                if g < 0:
                    models.append(None)
                    continue
                spec = res.orders[int(g)]
                p, d, q = spec.order
                k = spec.n_params(include_intercept)
                if spec.seasonal is not None:
                    m = SeasonalARIMAModel(spec.order, spec.seasonal,
                                           params[i, :k], include_intercept)
                else:
                    m = ARIMAModel(p, d, q, params[i, :k], include_intercept)
                    m.seasonal = None
                m.criterion_value = float(res.criterion[i])
                m.auto_result = res
                models.append(m)
            return models[0] if single else models


class ARModel(_ModelBase):
    def __init__(self, params, max_lag: int, device="cuda"):
        super().__init__(params, device)
        self.max_lag = max_lag

    @property
    def c(self) -> float:
        return float(self.params[0])

    def _meta(self) -> dict:
        return dict(max_lag=self.max_lag)

    @classmethod
    def _from_saved(cls, params, meta):
        return cls(params, int(meta["max_lag"]))

    def forecast(self, ts, n_future: int):
        return _host(_ar.forecast(self.params, _series(ts, self._device),
                                  self.max_lag, n_future,
                                  device=self._device))

    def _forecast_spec(self):
        return "autoregression", {"max_lag": self.max_lag}

    def add_time_dependent_effects(self, ts):
        return _host(_ar.add_time_dependent_effects(
            self.params, _series(ts, self._device), self.max_lag,
            device=self._device))

    def remove_time_dependent_effects(self, ts):
        return _host(_ar.remove_time_dependent_effects(
            self.params, _series(ts, self._device), self.max_lag,
            device=self._device))


class Autoregression:
    @staticmethod
    def fit_model(ts, max_lag: int = 1, no_intercept: bool = False,
                  device="cuda") -> ARModel:
        with obs.span("compat.fit_model", model="Autoregression"):
            res = _ar.fit(ts, max_lag, no_intercept,
                          device=_device_of(ts, device))
            return ARModel(res.params, max_lag)


class EWMAModel(_ModelBase):
    @property
    def smoothing(self) -> float:
        return float(self.params[0])

    def forecast(self, ts, n_future: int):
        return _host(_ewma.forecast(self.params, _series(ts, self._device),
                                    n_future, device=self._device))

    def _forecast_spec(self):
        return "ewma", {}

    def add_time_dependent_effects(self, ts):
        return _host(_ewma.add_time_dependent_effects(
            self.params, _series(ts, self._device), device=self._device))

    def remove_time_dependent_effects(self, ts):
        return _host(_ewma.remove_time_dependent_effects(
            self.params, _series(ts, self._device), device=self._device))


class EWMA:
    @staticmethod
    def fit_model(ts, checkpoint_dir: Optional[str] = None,
                  align_mode: Optional[str] = None, device="cuda",
                  **durable_kwargs) -> EWMAModel:
        dev = _device_of(ts, device)
        with obs.span("compat.fit_model", model="EWMA"):
            if checkpoint_dir is not None:
                return EWMAModel(_durable_fit(_ewma.fit, ts, checkpoint_dir,
                                              align_mode=align_mode,
                                              device=dev, **durable_kwargs))
            _require_checkpoint_dir(durable_kwargs)
            return EWMAModel(_ewma.fit(ts, align_mode=align_mode,
                                       device=dev).params)


class GARCHModel(_ModelBase):
    @property
    def omega(self) -> float:
        return float(self.params[0])

    @property
    def alpha(self) -> float:
        return float(self.params[1])

    @property
    def beta(self) -> float:
        return float(self.params[2])

    def _r(self, ts):
        return _series(ts, self._device).to(self._device)

    def log_likelihood(self, ts) -> float:
        r = self._r(ts)
        return float(_garch.log_likelihood(self.params.to(r.dtype), r))

    def forecast(self, ts, n_future: int):
        """Variance-path forecast (``models.garch.forecast``): conditional
        variances ``h_{T+1..T+n}`` — GARCH's mean forecast is zero."""
        return _host(_garch.forecast(self.params, _series(ts, self._device),
                                     n_future, device=self._device))

    def _forecast_spec(self):
        return "garch", {}

    def sample(self, n: int, seed: int = 0):
        return _host(_garch.sample(self.params, seed, n, device=self._device))

    def variances(self, ts):
        r = self._r(ts)
        return _host(_garch.variances(self.params.to(r.dtype), r))

    def add_time_dependent_effects(self, ts):
        return _host(_garch.add_time_dependent_effects(
            self.params, _series(ts, self._device), device=self._device))

    def remove_time_dependent_effects(self, ts):
        return _host(_garch.remove_time_dependent_effects(
            self.params, _series(ts, self._device), device=self._device))


class GARCH:
    @staticmethod
    def fit_model(ts, checkpoint_dir: Optional[str] = None,
                  align_mode: Optional[str] = None, device="cuda",
                  **durable_kwargs) -> GARCHModel:
        dev = _device_of(ts, device)
        with obs.span("compat.fit_model", model="GARCH"):
            if checkpoint_dir is not None:
                return GARCHModel(_durable_fit(_garch.fit, ts, checkpoint_dir,
                                               align_mode=align_mode,
                                               device=dev, **durable_kwargs))
            _require_checkpoint_dir(durable_kwargs)
            return GARCHModel(_garch.fit(ts, align_mode=align_mode,
                                         device=dev).params)


class ARGARCHModel(_ModelBase):
    def sample(self, n: int, seed: int = 0):
        return _host(_garch.argarch_sample(self.params, seed, n,
                                           device=self._device))


class ARGARCH:
    @staticmethod
    def fit_model(ts, align_mode: Optional[str] = None,
                  device="cuda") -> ARGARCHModel:
        with obs.span("compat.fit_model", model="ARGARCH"):
            return ARGARCHModel(_garch.fit_argarch(
                ts, align_mode=align_mode,
                device=_device_of(ts, device)).params)


class HoltWintersModel(_ModelBase):
    def __init__(self, params, period: int, model_type: str, device="cuda"):
        super().__init__(params, device)
        self.period = period
        self.model_type = model_type

    def _meta(self) -> dict:
        return dict(period=self.period, model_type=self.model_type)

    @classmethod
    def _from_saved(cls, params, meta):
        return cls(params, int(meta["period"]), str(meta["model_type"]))

    def forecast(self, ts, n_future: int):
        return _host(_hw.forecast(self.params, _series(ts, self._device),
                                  self.period, n_future, self.model_type,
                                  device=self._device))

    def _forecast_spec(self):
        return "holtwinters", {"period": self.period,
                               "model_type": self.model_type}

    def sse(self, ts) -> float:
        y = _series(ts, self._device).to(self._device)
        return float(_hw.sse(self.params.to(y.dtype), y, self.period,
                             self.model_type == "multiplicative"))


class HoltWinters:
    @staticmethod
    def fit_model(ts, period: int, model_type: str = "additive",
                  method: str = "BOBYQA",
                  checkpoint_dir: Optional[str] = None,
                  align_mode: Optional[str] = None, device="cuda",
                  **durable_kwargs) -> HoltWintersModel:
        # upstream's only optimizer is BOBYQA; here the bounded problem is
        # solved by sigmoid-transformed L-BFGS, so both names map to it
        if method not in ("BOBYQA", "L-BFGS"):
            raise ValueError(f"unknown method {method!r} (supported: BOBYQA, L-BFGS)")
        dev = _device_of(ts, device)
        with obs.span("compat.fit_model", model="HoltWinters"):
            if checkpoint_dir is not None:
                import functools

                params = _durable_fit(
                    functools.partial(_hw.fit, period=period,
                                      model_type=model_type),
                    ts, checkpoint_dir, align_mode=align_mode, device=dev,
                    **durable_kwargs)
                return HoltWintersModel(params, period, model_type)
            _require_checkpoint_dir(durable_kwargs)
            res = _hw.fit(ts, period, model_type=model_type,
                          align_mode=align_mode, device=dev)
            return HoltWintersModel(res.params, period, model_type)


class RegressionARIMAModel(_ModelBase):
    def predict(self, X):
        return _host(_regarima.predict(self.params, _series(X, self._device),
                                       device=self._device))


class RegressionARIMA:
    @staticmethod
    def fit_model(y, X, method: str = "cochrane-orcutt", device="cuda",
                  **kwargs) -> RegressionARIMAModel:
        with obs.span("compat.fit_model", model="RegressionARIMA"):
            res = _regarima.fit(y, X, method, device=_device_of(y, device),
                                **kwargs)
            return RegressionARIMAModel(res.params)


# ---------------------------------------------------------------------------
# statistical tests (upstream TimeSeriesStatisticalTests names)
# ---------------------------------------------------------------------------

adftest = _stats.adftest
dwtest = _stats.dwtest
bgtest = _stats.bgtest
bptest = _stats.bptest
lbtest = _stats.lbtest
kpsstest = _stats.kpsstest

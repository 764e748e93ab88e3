"""TimeSeriesPanel: a collection of series sharing one index (port of
``panel.py``).

The panel stores the whole collection as ONE dense tensor ``values[keys,
time]`` (NaN marks missing), a host ``keys`` array and a shared
``DateTimeIndex``.  The reference's operations map as follows:

=====================================  =======================================
reference (Spark)                      here (PyTorch)
=====================================  =======================================
``mapSeries(fn)`` per-series loop      ``torch.vmap(fn)`` over the keys axis
ingest ``groupByKey`` shuffle          host scatter by vectorized index lookup
``fill``/``differences``/...           panel-wide ``ops.univariate`` calls
                                       (the fill-chain and autocorrelation
                                       kernels on the card)
``toInstants`` shuffle (transpose)     one transposing copy
``seriesStats`` via StatCounter        NaN-aware reductions over time
``saveAsCsv`` + index string header    the reference's files (CSV / npz /
                                       Parquet), readable by either package
=====================================  =======================================

Host data becomes a tensor on ``device`` (default ``"cuda"``); a tensor
stays where it is.  A mesh-attached panel (``mesh=``, see
:mod:`.parallel.mesh`) pads its rows to a multiple of the mesh's series
size and keeps its values on the mesh's first device, where the
time-sharded functions of :mod:`.ops.seqparallel` split them.  pandas and
pyarrow are imported only by the methods that need them.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import index as dtix
from . import obs
from .index import DateTimeIndex, DateTimeLike
from .models.base import to_device
from .ops import univariate as uv
from .parallel import mesh as meshlib
from .parallel.mesh import Mesh

__all__ = ["TimeSeriesPanel", "from_observations", "from_dataframe",
           "from_series_dict"]


def _as_key_array(keys: Iterable) -> np.ndarray:
    return np.asarray(list(keys), dtype=object)


def _require_pyarrow():
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover - pyarrow is an extra
        raise ImportError(
            "Parquet persistence needs pyarrow (pip install "
            "spark-timeseries-tpu[parquet])"
        ) from e
    return pa, pq


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _device_kw(t) -> Optional[str]:
    """The ``device=`` a fit of tensor ``t`` runs with: where it lives."""
    if not isinstance(t, torch.Tensor):
        return None
    if t.device.type == "cuda" and t.device.index == torch.cuda.current_device():
        return "cuda"
    return str(t.device)


_BATCH_CACHE: Dict = {}
_BATCH_CACHE_MAX = 512
_MISSING = object()  # co_names entry not in fn.__globals__ (builtin/attribute)


class _ArrayIdKey:
    """Identity-based cache key for a tensor captured by a kernel (module
    constant, closure cell, default).  Holding the reference pins the id
    so it cannot be recycled; equality is identity, so a REBOUND capture
    produces a different key while the same tensor keeps hitting the
    cache.  (An in-place write to a captured tensor is not seen: the
    cached callable reads it at call time anyway.)  Captured-tensor memory
    is bounded by ``_BATCH_CACHE_MAX`` FIFO eviction; callers holding very
    large captured panels can ``_BATCH_CACHE.clear()``."""

    __slots__ = ("arr",)

    def __init__(self, arr):
        self.arr = arr

    def __hash__(self):
        return object.__hash__(self.arr)

    def __eq__(self, other):
        return isinstance(other, _ArrayIdKey) and self.arr is other.arr


def _hashable(v):
    return _ArrayIdKey(v) if isinstance(v, torch.Tensor) else v


def _fn_cache_key(fn: Callable):
    """A cache identity for ``fn`` that is stable across textually identical
    lambdas but distinguishes everything the function's behavior can depend
    on: module, qualname, bytecode, consts, defaults, closure values, the
    CURRENT values of referenced globals, and — for bound methods — the
    receiver plus a snapshot of its instance attributes (so mutating the
    receiver after a call cannot serve stale kernels).  Captured tensors
    key by identity (see ``_ArrayIdKey``); other unhashable captures (numpy
    arrays, lists) or not-yet-assigned cells raise (ValueError/TypeError)
    and the caller runs uncached."""
    self_obj = getattr(fn, "__self__", None)
    f = getattr(fn, "__func__", fn)
    code = getattr(f, "__code__", None)
    if code is None:  # functools.partial / callables: fall back to the object
        return fn
    cells = tuple(_hashable(c.cell_contents) for c in (f.__closure__ or ()))
    kwdefs = tuple((k, _hashable(v)) for k, v in sorted((f.__kwdefaults__ or {}).items()))
    defaults = tuple(_hashable(v) for v in (f.__defaults__ or ()))
    gl = f.__globals__
    gvals = tuple(_hashable(gl.get(n, _MISSING)) for n in code.co_names)
    if self_obj is None:
        self_key = None
    else:  # snapshot attribute VALUES: obj.c = 5.0 must change the key
        attrs = getattr(self_obj, "__dict__", None)
        self_key = (
            self_obj,
            tuple((k, _hashable(v)) for k, v in sorted(attrs.items()))
            if attrs is not None
            else None,
        )
    return (
        f.__module__, f.__qualname__, code.co_code, code.co_consts,
        code.co_names, defaults, kwdefs, cells, gvals, self_key,
    )


def _memo(fn: Callable, args: tuple, rows: bool) -> Callable:
    """The memoized panel callable of ``fn(., *args)`` with the reference's
    ``panel.map_series.cache_*`` accounting: ``torch.vmap`` of a ``[time]``
    function, or (``rows``) a function that already broadcasts over the
    keys axis called on the whole panel.  Entries are inserted only after
    the first successful call, so a function ``torch.vmap`` refuses never
    occupies a slot."""
    try:
        key = (_fn_cache_key(fn), args, rows)
        hash(key)  # lint: nondet(hashability probe for the in-process cache)
    except (TypeError, ValueError):  # unhashable capture / empty cell: uncached
        key = None
    if key is not None:
        hit = _BATCH_CACHE.get(key)
        if hit is not None:
            obs.counter("panel.map_series.cache_hits").inc()
            return hit
        obs.counter("panel.map_series.cache_misses").inc()
    else:
        obs.counter("panel.map_series.uncached").inc()
    if rows:
        def batched(v):
            return fn(v, *args)
    else:
        batched = uv.batched(fn, *args)
    if key is None:
        return batched

    @functools.wraps(batched)
    def call_then_cache(*a, **k):
        out = batched(*a, **k)  # a refused function caches nothing
        if len(_BATCH_CACHE) >= _BATCH_CACHE_MAX:
            _BATCH_CACHE.pop(next(iter(_BATCH_CACHE)))
        _BATCH_CACHE[key] = batched
        return out

    return call_then_cache


def _cached_batched(fn: Callable, *args) -> Callable:
    """``torch.vmap(fn(., *args))`` memoized so repeated panel method calls
    reuse one callable.  The cache keys on the function's bytecode,
    closure, referenced-global values and defaults rather than its object
    identity, so a fresh-but-identical lambda per call (the natural
    ``map_series`` usage) still hits it."""
    return _memo(fn, args, rows=False)


def _cached_rows(fn: Callable, *args) -> Callable:
    """:func:`_cached_batched` for the panel's own transforms: the
    ``ops.univariate`` functions broadcast over the keys axis, so they run
    on the whole panel at once (``torch.vmap`` would lose their kernels'
    batching rules), with the same cache accounting."""
    return _memo(fn, args, rows=True)


@functools.lru_cache(maxsize=8)
def _fused_fill_linear() -> Callable:
    """Memoized backend-dispatching linear fill (the fill-chain kernel on
    the card)."""
    return uv.batch_fill("linear")


@functools.lru_cache(maxsize=32)
def _fused_autocorr(num_lags: int) -> Callable:
    """Memoized backend-dispatching autocorrelation (one per lag count)."""
    return uv.batch_autocorr(num_lags)


def _panel_tensor(values, device, mesh: Optional[Mesh]) -> torch.Tensor:
    """``values`` as a tensor: a tensor as it is, host data on ``device``
    (the mesh's first device when there is a mesh)."""
    if isinstance(values, torch.Tensor):
        return values
    return to_device(values, meshlib._first_device(mesh) if mesh is not None
                     else device)


class TimeSeriesPanel:
    """A collection of series sharing one ``DateTimeIndex``.

    values: ``[padded_keys, time]`` tensor, NaN = missing.  Rows beyond
    ``n_series`` are NaN padding so the keys axis divides evenly across the
    mesh's ``series`` axis.  Host ``values`` go to ``device`` (default
    ``"cuda"``); a tensor is taken as it is, without a copy (a mesh moves
    it to the mesh's first device).
    """

    def __init__(
        self,
        index: DateTimeIndex,
        keys: Iterable,
        values,
        *,
        mesh: Optional[Mesh] = None,
        device="cuda",
        _pad_ok: bool = False,
    ):
        self.index = index
        self.keys = _as_key_array(keys)
        self.mesh = mesh
        vals = _panel_tensor(values, device, mesh)
        if vals.ndim != 2:
            raise ValueError(
                f"values must be [keys, time], got shape {tuple(vals.shape)}")
        if not _pad_ok and vals.shape[0] != len(self.keys):
            raise ValueError(
                f"{len(self.keys)} keys but values has {vals.shape[0]} rows"
            )
        if vals.shape[1] != index.size:
            raise ValueError(
                f"index size {index.size} but values has {vals.shape[1]} columns"
            )
        if mesh is not None:
            if meshlib.TIME_AXIS in mesh.axis_names:
                t_shards = mesh.shape[meshlib.TIME_AXIS]
                if vals.shape[1] % t_shards:
                    raise ValueError(
                        f"time axis of length {vals.shape[1]} does not divide across "
                        f"{t_shards} time shards; pad or slice the index to a multiple "
                        f"of {t_shards} (NaN time-padding would corrupt kernels)"
                    )
            n_shards = mesh.shape[meshlib.SERIES_AXIS]
            padded = meshlib.pad_to_multiple(vals.shape[0], n_shards)
            if padded != vals.shape[0]:
                pad = vals.new_full((padded - vals.shape[0], vals.shape[1]),
                                    torch.nan)
                vals = torch.cat([vals, pad], dim=0)
            vals = meshlib.shard_series(vals, mesh)
        self.values = vals

    # -- basics -------------------------------------------------------------

    @property
    def n_series(self) -> int:
        return len(self.keys)

    @property
    def n_time(self) -> int:
        return self.index.size

    @property
    def dtype(self):
        return self.values.dtype

    def series_values(self) -> torch.Tensor:
        """The unpadded ``[n_series, time]`` view."""
        return self.values[: self.n_series]

    def __len__(self) -> int:
        return self.n_series

    def __getitem__(self, key) -> torch.Tensor:
        """Single series by key — ``panel["AAPL"]`` -> ``[time]`` tensor."""
        locs = np.nonzero(self.keys == key)[0]
        if locs.size == 0:
            raise KeyError(key)
        return self.values[int(locs[0])]

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"TimeSeriesPanel({self.n_series} series x {self.n_time} instants, "
            f"dtype={self.dtype}, mesh={'yes' if self.mesh else 'no'})"
        )

    def _like(self, values, index: Optional[DateTimeIndex] = None, keys=None) -> "TimeSeriesPanel":
        return TimeSeriesPanel(
            index if index is not None else self.index,
            keys if keys is not None else self.keys,
            values,
            mesh=self.mesh,
            _pad_ok=True,
        )

    # -- the hot path -------------------------------------------------------

    def map_series(
        self,
        fn: Callable[[torch.Tensor], torch.Tensor],
        new_index: Optional[DateTimeIndex] = None,
    ) -> "TimeSeriesPanel":
        """Apply a ``[time] -> [time']`` function to every series, as one
        ``torch.vmap`` over the keys axis (``torch.vmap`` refuses
        data-dependent Python control flow inside ``fn``, as ``jax.vmap``
        does).

        The batched callables are cached on the function's bytecode,
        closure and referenced-global values (not object identity), so a
        fresh but textually identical lambda each call reuses one entry;
        functions whose closures capture unhashable state run uncached.
        Cache hits/misses feed the telemetry registry
        (``panel.map_series.cache_*``) when ``obs`` is enabled.
        """
        with obs.span("panel.map_series", n_series=self.n_series):
            out = _cached_batched(fn)(self.values)
        idx = new_index if new_index is not None else self.index
        if out.ndim != 2 or out.shape[1] != idx.size:
            raise ValueError(
                f"map_series output shape {tuple(out.shape)} does not match "
                f"index size {idx.size}; pass new_index= for length-changing "
                "transforms"
            )
        return self._like(out, index=idx)

    def to_folded(self):
        """Values in the kernels' resident layout (``ops.layout``):
        ``FoldedPanel`` — fold once at the panel boundary, then every
        transform dispatch on it runs with no per-dispatch layout
        transpose.  Pass it to ``ops.univariate.batch_autocorr`` /
        ``batch_fill_linear_chain``; ``ops.unfold_panel`` converts back."""
        from .ops.layout import fold_panel

        return fold_panel(self.series_values())

    def fill(self, method: str, value=None) -> "TimeSeriesPanel":
        # a panel with no mesh takes the fill-chain kernel on the card (the
        # dispatcher runs the plain fill elsewhere); a mesh-attached panel
        # keeps the plain path, as the reference keeps its vmap path
        if method == "linear" and self.mesh is None:
            return self._like(_fused_fill_linear()(self.values))
        return self._apply(uv.fillts, method, value)

    def differences(self, lag: int = 1) -> "TimeSeriesPanel":
        return self._apply(uv.differences_at_lag, lag)

    def quotients(self, lag: int = 1) -> "TimeSeriesPanel":
        return self._apply(uv.quotients, lag)

    def return_rates(self, lag: int = 1) -> "TimeSeriesPanel":
        return self._apply(uv.price2ret, lag)

    def _apply(self, kernel: Callable, *args) -> "TimeSeriesPanel":
        return self._like(_cached_rows(kernel, *args)(self.values))

    def autocorr(self, num_lags: int) -> torch.Tensor:
        """``[n_series, num_lags]`` sample autocorrelations."""
        if self.mesh is None:  # the autocorrelation kernel on the card
            out = _fused_autocorr(num_lags)(self.values)
        else:
            out = _cached_rows(uv.autocorr, num_lags)(self.values)
        return out[: self.n_series]

    def pacf(self, num_lags: int) -> torch.Tensor:
        """``[n_series, num_lags]`` partial autocorrelations (Durbin-Levinson)."""
        out = _cached_rows(uv.pacf, num_lags)(self.values)
        return out[: self.n_series]

    def _walk_values(self, source):
        """The panel's rows for a chunk walk: its tensor, or ``source``
        (a host array, npz/parquet shard directory or ``ChunkSource``
        holding THIS panel's values)."""
        if source is None:
            return self.series_values()
        from .reliability import source as source_mod

        src = source_mod.as_source(source)
        if tuple(src.shape) != (int(self.n_series), int(self.n_time)):
            raise ValueError(
                f"source shape {src.shape} does not match this panel "
                f"({self.n_series} series x {self.n_time} obs); the "
                "source must hold the panel's own values")
        return src

    def fit(self, model, *, chunk_rows: Optional[int] = None,
            resilient: bool = True, policy: str = "impute",
            checkpoint_dir: Optional[str] = None, resume: str = "auto",
            chunk_budget_s: Optional[float] = None,
            job_budget_s: Optional[float] = None,
            pipeline: bool = True, pipeline_depth: int = 2,
            prefetch_depth: int = 1, align_mode: Optional[str] = None,
            shard: bool = False, mesh=None, source=None,
            delta_from: Optional[str] = None, delta_warmstart: bool = True,
            **fit_kwargs):
        """Fit a model family over every series via the journaled chunk
        walk (``reliability.fit_chunked``).

        ``model`` is a model-module name (``"arima"``, ``"garch"``,
        ``"ewma"``, ``"holtwinters"``, ``"autoregression"``) or any
        callable ``fit(values, **kwargs) -> FitResult``.  The panel is
        fitted in row chunks of at most ``chunk_rows`` (default: one chunk)
        with bounded out-of-memory backoff, and — unless
        ``resilient=False`` — each chunk runs the sanitize -> fit -> retry
        -> fallback ladder (``reliability.resilient_fit``).
        ``checkpoint_dir=`` journals every finished chunk so a restarted
        call resumes bitwise-identical; ``chunk_budget_s`` /
        ``job_budget_s`` bound the wall clock; journaled walks commit in
        the background (``pipeline``) and stage the next chunk ahead
        (``prefetch_depth``), still bitwise-identical to the serial walk;
        ``delta_from=`` refits only the chunks whose rows changed since a
        prior journal; ``source=`` walks a host-resident copy of the
        panel's values through pinned staging buffers.  ``shard=True`` /
        ``mesh=`` run the multi-lane walk (one lane per series-axis device
        of the mesh, bitwise the single-lane walk).  The fit runs where
        the panel's values live unless ``device=`` says otherwise.

        Returns a ``reliability.ResilientFitResult`` whose rows align with
        ``self.keys``; ``.status`` carries per-series ``FitStatus`` codes
        and ``.meta`` the chunk/ladder/journal accounting.
        """
        if callable(model):
            fit_fn = model
        else:
            from . import models as _models

            mod = getattr(_models, model, None)
            if mod is None or not hasattr(mod, "fit"):
                raise ValueError(f"unknown model {model!r}")
            fit_fn = mod.fit
        from .reliability import fit_chunked

        values = self._walk_values(source)
        if _device_kw(values) is not None:
            fit_kwargs.setdefault("device", _device_kw(values))
        model_name = (model if isinstance(model, str)
                      else getattr(model, "__qualname__", repr(model)))
        with obs.span("panel.fit", model=model_name, n_series=self.n_series):
            return fit_chunked(
                fit_fn, values, chunk_rows=chunk_rows,
                resilient=resilient, policy=policy,
                checkpoint_dir=checkpoint_dir, resume=resume,
                chunk_budget_s=chunk_budget_s, job_budget_s=job_budget_s,
                pipeline=pipeline, pipeline_depth=pipeline_depth,
                prefetch_depth=prefetch_depth, align_mode=align_mode,
                shard=shard, mesh=mesh,
                delta_from=delta_from, delta_warmstart=delta_warmstart,
                **fit_kwargs,
            )

    def auto_fit(self, orders=None, *, criterion: str = "aicc",
                 include_intercept: bool = True, stage2: str = "full",
                 stage1_iters: int = 12,
                 chunk_rows: Optional[int] = None,
                 resilient: bool = False, policy: str = "impute",
                 checkpoint_dir: Optional[str] = None, resume: str = "auto",
                 chunk_budget_s: Optional[float] = None,
                 job_budget_s: Optional[float] = None,
                 pipeline: bool = True, pipeline_depth: int = 2,
                 prefetch_depth: int = 1, align_mode: Optional[str] = None,
                 shard: bool = False, mesh=None, source=None,
                 **fit_kwargs):
        """Batched ARIMA/SARIMA order search over every series
        (``models.auto.auto_fit``): a static grid of candidate orders per
        series (default ``models.auto.DEFAULT_ORDERS``), ``criterion``
        (AICc default) per (row, order) on the device, arg-selected per
        row.  Every candidate rides the same chunk walk as :meth:`fit`
        (per-order journals under ``checkpoint_dir/grid_00000/…``, resume,
        budgets, ``source=``); ``stage2="winners"`` sweeps every order at
        ``stage1_iters`` first and spends the full budget only on each
        row's winner.  Returns a ``models.auto.AutoFitResult`` whose rows
        align with ``self.keys``."""
        from .models import auto as _auto

        values = self._walk_values(source)
        if _device_kw(values) is not None:
            fit_kwargs.setdefault("device", _device_kw(values))
        with obs.span("panel.auto_fit", n_series=self.n_series,
                      orders=len(_auto.normalize_orders(orders))):
            return _auto.auto_fit(
                values, orders, criterion=criterion,
                include_intercept=include_intercept, stage2=stage2,
                stage1_iters=stage1_iters, chunk_rows=chunk_rows,
                resilient=resilient, policy=policy,
                checkpoint_dir=checkpoint_dir, resume=resume,
                chunk_budget_s=chunk_budget_s, job_budget_s=job_budget_s,
                pipeline=pipeline, pipeline_depth=pipeline_depth,
                prefetch_depth=prefetch_depth, align_mode=align_mode,
                shard=shard, mesh=mesh, **fit_kwargs)

    def forecast(self, model, horizon, fitted, *, status=None,
                 intervals: bool = False, level: float = 0.9,
                 n_samples: int = 256, seed: Optional[int] = None,
                 chunk_rows: Optional[int] = None,
                 checkpoint_dir: Optional[str] = None, resume: str = "auto",
                 chunk_budget_s: Optional[float] = None,
                 job_budget_s: Optional[float] = None,
                 pipeline: bool = True, pipeline_depth: int = 2,
                 prefetch_depth: int = 1, shard: bool = False, mesh=None,
                 source=None, _journal_commit_hook=None, **model_kwargs):
        """Forecast ``horizon`` steps for every series via the chunked
        forecast walk (``forecasting.forecast_chunked``).

        ``model`` is a forecast-capable model name (``"arima"``,
        ``"autoregression"``, ``"ewma"``, ``"holtwinters"``, ``"garch"``);
        ``model_kwargs`` its structural config (e.g. ``order=(1, 1, 1)``).
        ``fitted`` supplies the per-row params: the result a previous
        :meth:`fit` returned, a raw ``[n_series, k]`` array, or a PATH to
        a fit walk's journal.  An :meth:`auto_fit` selection is rejected
        (forecast it with ``forecasting.ensemble_forecast``).  Rows whose
        fit failed forecast NaN and keep their ``FitStatus``.  The walk
        rides the same chunk driver as :meth:`fit` (journal, resume,
        ``source=``); ``intervals=True`` adds Monte-Carlo ``level`` bands
        seeded per global row.  The walk runs where the panel's values
        live unless ``device=`` says otherwise (taken out of
        ``model_kwargs``).  Returns a ``forecasting.ForecastResult`` whose
        rows align with ``self.keys``.
        """
        from . import forecasting as _forecasting

        values = self._walk_values(source)
        device = model_kwargs.pop("device", _device_kw(values) or "cuda")
        return _forecasting.forecast_chunked(
            model, fitted, values, horizon,
            model_kwargs=model_kwargs, status=status,
            intervals=intervals, level=level, n_samples=n_samples,
            seed=seed, chunk_rows=chunk_rows,
            checkpoint_dir=checkpoint_dir, resume=resume,
            chunk_budget_s=chunk_budget_s, job_budget_s=job_budget_s,
            pipeline=pipeline, pipeline_depth=pipeline_depth,
            prefetch_depth=prefetch_depth, shard=shard, mesh=mesh,
            _journal_commit_hook=_journal_commit_hook, device=device)

    def backtest(self, model, horizon, *, checkpoint_dir: Optional[str] = None,
                 **backtest_kwargs):
        """Rolling-origin backtest campaign over this panel
        (``forecasting.run_backtest``): expanding-window refits x a
        ``horizon`` sweep as ONE journaled campaign, warm-started
        window-to-window, with MAE/RMSE/MAPE/coverage in a durable
        ``backtest_manifest.json``.  See ``forecasting.run_backtest`` for
        the knobs; it runs where the panel's values live unless
        ``device=`` says otherwise."""
        from . import forecasting as _forecasting

        values = self.series_values()
        backtest_kwargs.setdefault("device", _device_kw(values))
        return _forecasting.run_backtest(
            values, model, horizon,
            checkpoint_dir=checkpoint_dir, **backtest_kwargs)

    def lags(self, max_lag: int, include_original: bool = True,
             lagged_key: Callable[[object, int], object] = None) -> "TimeSeriesPanel":
        """Panel of lagged copies of every series — the upstream
        ``TimeSeries.lags(maxLag, includeOriginals, laggedKey)`` feature-matrix
        builder, panel-shaped: output rows are ``key`` (if
        ``include_original``) followed by ``lag1(key) .. lagN(key)`` for each
        input key; lagged rows lead with NaNs.
        """
        if lagged_key is None:
            lagged_key = lambda k, i: f"lag{i}({k})"
        ks = range(0 if include_original else 1, max_lag + 1)
        # [n, time, len(ks)] -> [n, len(ks), time]
        out = _cached_rows(uv.lags, max_lag, include_original)(
            self.series_values()
        ).permute(0, 2, 1)
        new_keys = [lagged_key(k, i) if i else k for k in self.keys for i in ks]
        return TimeSeriesPanel(
            self.index, new_keys, out.reshape(-1, self.n_time), mesh=self.mesh
        )

    # -- time-axis restructuring -------------------------------------------

    def slice(self, start: DateTimeLike, end: DateTimeLike) -> "TimeSeriesPanel":
        lo, hi = self.index.loc_range(start, end)
        return self.islice(lo, hi)

    def islice(self, start: int, end: int) -> "TimeSeriesPanel":
        return self._like(self.values[:, start:end], index=self.index.islice(start, end))

    def with_index(self, new_index: DateTimeIndex, how: str = "nan") -> "TimeSeriesPanel":
        """Reindex onto ``new_index``: positions present in both indices are
        copied; new positions are NaN (``how="nan"``) — the upstream
        ``withIndex`` contract.  Chain ``.fill(...)`` for other semantics."""
        if how != "nan":
            raise ValueError(f"unsupported how={how!r}; reindex then .fill(...)")
        locs = self.index.locs_at_datetimes(new_index.instants())  # [new_time]
        dev = self.values.device
        hit = torch.as_tensor(locs >= 0, device=dev)
        gathered = self.values[:, torch.as_tensor(np.maximum(locs, 0),
                                                  device=dev)]
        out = torch.where(hit[None, :], gathered, torch.nan)
        return self._like(out, index=new_index)

    def remove_instants_with_nans(self) -> "TimeSeriesPanel":
        """Drop time positions where ANY series is NaN (host-side dynamic
        shape — upstream ``removeInstantsWithNaNs``)."""
        col_ok = _host(~torch.isnan(self.series_values()).any(0))
        keep = np.nonzero(col_ok)[0]
        new_index = dtix.IrregularDateTimeIndex(self.index.instants()[keep])
        return self._like(
            self.values[:, torch.as_tensor(keep, device=self.values.device)],
            index=new_index)

    # -- key-axis restructuring (host-side ingest-path ops) -----------------

    def filter_keys(self, predicate: Callable[[object], bool]) -> "TimeSeriesPanel":
        mask = np.array([bool(predicate(k)) for k in self.keys])
        return self._select_rows(np.nonzero(mask)[0])

    def select(self, keys: Sequence) -> "TimeSeriesPanel":
        pos = {k: i for i, k in enumerate(self.keys)}
        missing = [k for k in keys if k not in pos]
        if missing:
            raise KeyError(f"keys not in panel: {missing[:5]}")
        return self._select_rows(np.array([pos[k] for k in keys], dtype=np.int64))

    def _select_rows(self, rows: np.ndarray) -> "TimeSeriesPanel":
        sv = self.series_values()
        vals = (sv[torch.as_tensor(rows, device=sv.device)] if rows.size
                else sv.new_zeros((0, self.n_time)))
        return TimeSeriesPanel(self.index, self.keys[rows], vals, mesh=self.mesh)

    def filter_starting_before(self, dt: DateTimeLike) -> "TimeSeriesPanel":
        """Keep series whose first observation is at or before ``dt``."""
        cutoff = self.index.insertion_loc(dt)
        first = _host(uv.first_not_nan_loc(self.series_values()))
        return self._select_rows(np.nonzero(first < cutoff)[0])

    def filter_ending_after(self, dt: DateTimeLike) -> "TimeSeriesPanel":
        """Keep series whose last observation is at or after ``dt``."""
        if dtix.to_nanos(dt) > dtix.to_nanos(self.index.last):
            return self._select_rows(np.array([], dtype=np.int64))
        lo = self.index.loc_at_or_after(dt)
        last = _host(uv.last_not_nan_loc(self.series_values()))
        return self._select_rows(np.nonzero(last >= lo)[0])

    def union(self, other: "TimeSeriesPanel") -> "TimeSeriesPanel":
        if self.index != other.index:
            raise ValueError("union requires identical indices")
        keys = np.concatenate([self.keys, other.keys])
        a = self.series_values()
        vals = torch.cat([a, other.series_values().to(a.device)], dim=0)
        return TimeSeriesPanel(self.index, keys, vals, mesh=self.mesh)

    # -- aggregates and exits ----------------------------------------------

    def series_stats(self) -> Dict[str, torch.Tensor]:
        """NaN-aware per-series stats — upstream ``seriesStats`` (StatCounter
        per series).  Returns ``[n_series]`` tensors."""
        v = self.series_values()
        valid = ~torch.isnan(v)
        n = valid.sum(1)
        mean = torch.where(valid, v, 0.0).sum(1) / torch.clamp(n, min=1)
        var = (torch.where(valid, (v - mean[:, None]) ** 2, 0.0).sum(1)
               / torch.clamp(n - 1, min=1))
        some = n > 0
        return {
            "count": n,
            "mean": mean,
            "stdev": torch.sqrt(var),
            "min": torch.where(some, torch.where(valid, v, torch.inf)
                               .amin(1), torch.nan),
            "max": torch.where(some, torch.where(valid, v, -torch.inf)
                               .amax(1), torch.nan),
        }

    def to_instants(self) -> Tuple[np.ndarray, torch.Tensor]:
        """Time-major view: ``(datetimes[time], values[time, n_series])``.

        The reference implements this as a full cluster shuffle; here it
        is one transposing copy on the panel's device.
        """
        vals = self.series_values().t().contiguous()
        return self.index.datetimes(), vals

    def to_row_matrix(self) -> torch.Tensor:
        """``[time, n_series]`` instant-major matrix — the named analog of the
        reference's ``toRowMatrix`` (MLlib RowMatrix whose rows are instants).
        Same data as :meth:`to_instants` without the datetimes."""
        return self.to_instants()[1]

    def to_indexed_row_matrix(self) -> Tuple[np.ndarray, torch.Tensor]:
        """``(row_indices[time], values[time, n_series])`` — the reference's
        ``toIndexedRowMatrix``: each row is an instant tagged with its integer
        location on the index."""
        return np.arange(self.n_time), self.to_instants()[1]

    def to_instants_dataframe(self):
        import pandas as pd

        dts, vals = self.to_instants()
        return pd.DataFrame(_host(vals), index=pd.DatetimeIndex(dts),
                            columns=list(self.keys))

    def to_observations_dataframe(self, ts_col="timestamp", key_col="key", value_col="value"):
        """Long-format (timestamp, key, value) rows, NaNs dropped — the
        inverse of ``from_observations``."""
        import pandas as pd

        vals = _host(self.series_values())
        kidx, tidx = np.nonzero(~np.isnan(vals))
        return pd.DataFrame(
            {
                ts_col: self.index.datetimes()[tidx],
                key_col: self.keys[kidx],
                value_col: vals[kidx, tidx],
            }
        )

    def to_pandas(self):
        """Series-major DataFrame: rows = keys, columns = datetimes."""
        import pandas as pd

        return pd.DataFrame(
            _host(self.series_values()),
            index=list(self.keys),
            columns=pd.DatetimeIndex(self.index.datetimes()),
        )

    # -- persistence --------------------------------------------------------

    def save_csv(self, path: str) -> None:
        """One line per series: ``key,indexString`` header convention of the
        reference's ``saveAsCsv``: every line is ``key,v0,v1,...`` and the
        first line carries the encoded index.

        Persistence coerces keys to ``str`` — a load round-trip yields string
        keys.  Keys containing ',' are rejected (they would corrupt rows).
        """
        if any("," in str(k) for k in self.keys):
            raise ValueError("CSV persistence does not support keys containing ','")
        vals = _host(self.series_values())
        with open(path, "w") as f:
            f.write(f"# index: {self.index.to_string()}\n")
            for k, row in zip(self.keys, vals):
                f.write(str(k) + "," + ",".join(repr(float(v)) for v in row) + "\n")

    @staticmethod
    def load_csv(path: str, mesh: Optional[Mesh] = None,
                 device="cuda") -> "TimeSeriesPanel":
        with open(path) as f:
            header = f.readline()
            if not header.startswith("# index: "):
                raise ValueError(f"{path} missing '# index:' header")
            index = dtix.from_string(header[len("# index: ") :].strip())
            keys, rows = [], []
            for line in f:
                parts = line.rstrip("\n").split(",")
                keys.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
        return TimeSeriesPanel(index, keys, np.asarray(rows), mesh=mesh,
                               device=device)

    def save(self, path: str) -> None:
        """Binary checkpoint (npz): values + keys + index string."""
        np.savez_compressed(
            path,
            values=_host(self.series_values()),
            keys=np.asarray([str(k) for k in self.keys]),
            index=self.index.to_string(),
        )

    @staticmethod
    def load(path: str, mesh: Optional[Mesh] = None,
             device="cuda") -> "TimeSeriesPanel":
        if not path.endswith(".npz") and not os.path.exists(path):
            path = path + ".npz"
        z = np.load(path, allow_pickle=False)
        return TimeSeriesPanel(
            dtix.from_string(str(z["index"])), list(z["keys"]), z["values"],
            mesh=mesh, device=device,
        )

    def save_parquet(self, path: str, *, row_group_series: int = 16384) -> None:
        """Columnar checkpoint via Arrow/Parquet (the reference's
        ``saveAsParquetDataFrame`` / ``timeSeriesRDDFromParquet`` pair).

        Layout is SERIES-major — one row per series, schema
        ``key: string, values: fixed_size_list<float>[n_time]`` with the
        encoded ``DateTimeIndex`` in the file metadata, so rows write
        incrementally in row groups of ``row_group_series`` and Arrow-side
        memory stays one row group beyond the single host copy of the
        panel.  Keys are coerced to ``str`` (same contract as
        ``save_csv``).  The schema and metadata keys are the reference's,
        so either package reads the other's files.
        """
        pa, pq = _require_pyarrow()
        vals = _host(self.series_values())
        t = vals.shape[1]
        schema = pa.schema(
            [("key", pa.string()), ("values", pa.list_(pa.from_numpy_dtype(vals.dtype), t))],
            metadata={
                b"spark_timeseries_tpu.index": self.index.to_string().encode(),
                b"spark_timeseries_tpu.version": b"1",
            },
        )
        with pq.ParquetWriter(path, schema) as writer:
            for lo in range(0, vals.shape[0], row_group_series):
                chunk = vals[lo : lo + row_group_series]
                arr = pa.FixedSizeListArray.from_arrays(
                    pa.array(chunk.reshape(-1)), t
                )
                keys = pa.array(
                    [str(k) for k in self.keys[lo : lo + row_group_series]],
                    pa.string(),
                )
                writer.write_table(
                    pa.Table.from_arrays([keys, arr], schema=schema)
                )

    @staticmethod
    def load_parquet(path: str, mesh: Optional[Mesh] = None,
                     device="cuda") -> "TimeSeriesPanel":
        """Load a :meth:`save_parquet` checkpoint (round-trips keys as str,
        values bit-exact, and the index through its string codec)."""
        pa, pq = _require_pyarrow()
        table = pq.read_table(path)
        meta = table.schema.metadata or {}
        enc = meta.get(b"spark_timeseries_tpu.index")
        if enc is None:
            raise ValueError(
                f"{path} is not a spark_timeseries_tpu panel checkpoint "
                "(missing index metadata)"
            )
        index = dtix.from_string(enc.decode())
        vtype = table.schema.field("values").type
        t = vtype.list_size
        n = len(table)
        if n:
            col = table.column("values").combine_chunks()
            vals = np.asarray(col.flatten()).reshape(n, t)
        else:
            vals = np.empty((0, t), np.dtype(vtype.value_type.to_pandas_dtype()))
        keys = table.column("key").to_pylist()
        return TimeSeriesPanel(index, keys, vals, mesh=mesh, device=device)

    # -- resharding ---------------------------------------------------------

    def with_mesh(self, mesh: Optional[Mesh]) -> "TimeSeriesPanel":
        return TimeSeriesPanel(self.index, self.keys, self.series_values(), mesh=mesh)


# ---------------------------------------------------------------------------
# Ingest
# ---------------------------------------------------------------------------


def _unique_keys(keys):
    """``(sorted distinct keys as an object array, row of each key)``:
    numpy's own sort for an integer or string array, else Python's order
    on the key objects."""
    if isinstance(keys, np.ndarray) and keys.dtype.kind in "biuUS":
        uniq, rows = np.unique(keys, return_inverse=True)
        return uniq.astype(object), rows.reshape(-1)
    uniq, rows = np.unique(_as_key_array(keys), return_inverse=True)
    return uniq, rows.reshape(-1)


def from_observations(
    index: DateTimeIndex,
    keys,
    timestamps,
    values,
    *,
    mesh: Optional[Mesh] = None,
    dtype=torch.float32,
    strict: bool = False,
    device="cuda",
) -> TimeSeriesPanel:
    """Build a panel from long-format observation triples.

    Replaces the reference's ``timeSeriesRDDFromObservations`` groupByKey
    shuffle with a host-side vectorized scatter: timestamps -> positions
    via one ``searchsorted``-style lookup, keys -> rows via factorization,
    then one ``values[rows, locs] = v`` write into a host panel of
    ``dtype`` (each value rounded from float64 once, as the reference's
    float64 panel cast to ``dtype``), moved to ``device``.

    Observations whose timestamp is not on the index raise (``strict=True``)
    or are dropped (default).  The resulting panel's keys are SORTED
    (lexicographically for strings) — align downstream arrays with
    ``panel.keys``, not with insertion order.
    """
    vals = np.asarray(values, dtype=np.float64)
    locs = index.locs_at_datetimes(timestamps)
    uniq, rows = _unique_keys(keys)
    ok = locs >= 0
    if strict and not ok.all():
        bad = np.nonzero(~ok)[0][:5]
        raise ValueError(f"{(~ok).sum()} observations not on the index, e.g. rows {bad}")
    panel = np.full((len(uniq), index.size), np.nan, dtype=_np_dtype(dtype))
    panel[rows[ok], locs[ok]] = vals[ok]
    return TimeSeriesPanel(index, uniq, _panel_tensor(panel, device, mesh),
                           mesh=mesh)


def from_dataframe(
    df,
    index: Optional[DateTimeIndex] = None,
    *,
    ts_col: str = "timestamp",
    key_col: str = "key",
    value_col: str = "value",
    mesh: Optional[Mesh] = None,
    dtype=torch.float32,
    device="cuda",
) -> TimeSeriesPanel:
    """Panel from a long-format pandas DataFrame.  If ``index`` is None an
    irregular index over the distinct timestamps is built."""
    ts = df[ts_col].to_numpy()
    if index is None:
        index = dtix.IrregularDateTimeIndex(np.unique(dtix.to_nanos_array(ts)))
    return from_observations(
        index, df[key_col].to_numpy(), ts, df[value_col].to_numpy(),
        mesh=mesh, dtype=dtype, device=device,
    )


def from_series_dict(
    series: Dict[object, np.ndarray],
    index: DateTimeIndex,
    *,
    mesh: Optional[Mesh] = None,
    dtype=torch.float32,
    device="cuda",
) -> TimeSeriesPanel:
    keys = list(series.keys())
    vals = np.stack([np.asarray(series[k], dtype=np.float64) for k in keys])
    return TimeSeriesPanel(
        index, keys, _panel_tensor(vals.astype(_np_dtype(dtype)), device,
                                   mesh), mesh=mesh)

"""The port's ``TimeSeriesPanel`` (``panel.py``) against the reference's.

Every method and ingest function on the same inputs: values bit for bit
for the restructuring methods and the exits, the transforms,
``series_stats`` and ``autocorr`` / ``pacf`` within float tolerance, the
``map_series`` memo and its ``panel.map_series.cache_*`` counters call for
call, ``fit`` / ``forecast`` / ``auto_fit`` against the reference at the
port's fit-test bars (and ``panel.fit`` bit for bit ``fit_chunked``: the
panel is glue), and the CSV, npz and Parquet files read across packages
in both directions.  Panels are float64 unless a test says otherwise
(``tests/conftest.py`` enables x64), and each side gets its own copy.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

import spark_timeseries_tpu as ref
from spark_timeseries_tpu import index as rix
from spark_timeseries_tpu import obs as robs
from spark_timeseries_tpu import panel as rpanel
from spark_timeseries_tpu.ops import layout as rlayout
import spark_timeseries_tpu_torch as port
from spark_timeseries_tpu_torch import index as pix
from spark_timeseries_tpu_torch import obs as pobs
from spark_timeseries_tpu_torch import panel as ppanel
from spark_timeseries_tpu_torch import forecasting, reliability
from spark_timeseries_tpu_torch.models import arima, auto
from spark_timeseries_tpu_torch.ops.layout import FoldedPanel, unfold_panel

nan = np.nan
KEYS = ["a", "b", "c"]
SMALL = [[1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
         [nan, 20.0, nan, 40.0, 50.0, nan],
         [9.0, 8.0, 7.0, 6.0, 5.0, 4.0]]


def _index(mod, start="2020-01-01", n=6):
    return mod.uniform(start, n, mod.DayFrequency(1))


def _pair(values, keys=KEYS, start="2020-01-01", dtype=np.float64):
    v = np.asarray(values, dtype=dtype)
    n = v.shape[1]
    return (port.TimeSeriesPanel(_index(pix, start, n), keys,
                                 torch.as_tensor(v.copy())),
            ref.TimeSeriesPanel(_index(rix, start, n), keys,
                                jnp.asarray(v.copy())))


def _wide(seed=5, b=12, t=40):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(b, t)).cumsum(axis=1) + 30.0
    v[rng.random((b, t)) < 0.15] = nan
    v[0, :6] = nan  # leading run
    v[1, -4:] = nan  # trailing run
    v[2, :] = nan  # all NaN
    return v


WIDE_KEYS = [f"s{i:02d}" for i in range(12)]


def _same(p, r):
    """Same keys, index and values bit for bit (NaN where NaN)."""
    assert p.keys.tolist() == r.keys.tolist()
    assert p.index.to_string() == r.index.to_string()
    assert p.values.shape == tuple(r.values.shape)
    np.testing.assert_array_equal(p.series_values().numpy(),
                                  np.asarray(r.series_values()))


# ---------------------------------------------------------------------------
# basics and restructuring (bit for bit)
# ---------------------------------------------------------------------------


def test_basics():
    p, r = _pair(SMALL)
    assert (p.n_series, p.n_time, len(p)) == (r.n_series, r.n_time, len(r))
    assert p.dtype == torch.float64
    np.testing.assert_array_equal(p["b"].numpy(), np.asarray(r["b"]))
    with pytest.raises(KeyError):
        p["zz"]
    assert p.values is p.values and p.mesh is None


def test_a_tensor_is_taken_without_a_copy():
    v = torch.as_tensor(np.asarray(SMALL))
    p = port.TimeSeriesPanel(_index(pix), KEYS, v)
    assert p.values is v
    assert p.series_values().data_ptr() == v.data_ptr()


def test_host_values_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.TimeSeriesPanel(_index(pix), KEYS, np.asarray(SMALL))
    p = port.TimeSeriesPanel(_index(pix), KEYS, np.asarray(SMALL),
                             device="cpu")
    assert p.values.device.type == "cpu"


@pytest.mark.parametrize("what", [
    "islice", "slice", "with_index", "remove_instants", "filter_keys",
    "select", "starting_before", "ending_after", "ending_after_past",
    "union", "lags", "lags_no_original", "map_series", "map_series_index",
    "with_mesh_none"])
def test_restructuring_is_bitwise(what):
    p, r = _pair(_wide(), WIDE_KEYS)
    ops = {
        "islice": lambda x, m: x.islice(3, 31),
        "slice": lambda x, m: x.slice("2020-01-05", "2020-01-20"),
        "with_index": lambda x, m: x.with_index(
            m.uniform("2019-12-25", 60, m.DayFrequency(1))),
        "remove_instants": lambda x, m: x.filter_keys(
            lambda k: k != "s02").remove_instants_with_nans(),
        "filter_keys": lambda x, m: x.filter_keys(lambda k: k > "s05"),
        "select": lambda x, m: x.select(["s07", "s01", "s03"]),
        "starting_before": lambda x, m: x.filter_starting_before(
            "2020-01-03"),
        "ending_after": lambda x, m: x.filter_ending_after("2020-02-08"),
        "ending_after_past": lambda x, m: x.filter_ending_after(
            "2021-01-01"),
        "union": lambda x, m: x.union(x.select(["s04"])),
        "lags": lambda x, m: x.lags(2),
        "lags_no_original": lambda x, m: x.lags(
            3, include_original=False, lagged_key=lambda k, i: (k, i)),
        "map_series": lambda x, m: x.map_series(lambda v: v * 2.0 - 1.0),
        "map_series_index": lambda x, m: x.map_series(
            lambda v: v[2:], new_index=x.index.islice(2, 40)),
        "with_mesh_none": lambda x, m: x.with_mesh(None),
    }
    _same(ops[what](p, pix), ops[what](r, rix))


def test_restructuring_errors_match():
    p, r = _pair(SMALL)
    for x in (p, r):
        with pytest.raises(KeyError):
            x.select(["zz"])
        with pytest.raises(ValueError):
            x.map_series(lambda v: v[:-1])  # shrank without new_index
        with pytest.raises(ValueError):
            x.with_index(x.index, how="ffill")
    with pytest.raises(ValueError, match="identical indices"):
        p.union(p.islice(0, 5))


# ---------------------------------------------------------------------------
# transforms (float tolerance) and aggregates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-5)])
@pytest.mark.parametrize("what", [
    "fill_linear", "fill_previous", "fill_next", "fill_nearest", "fill_zero",
    "fill_value", "fill_spline", "differences", "differences_3",
    "quotients", "return_rates"])
def test_transforms_match(what, dtype, rtol):
    p, r = _pair(_wide(), WIDE_KEYS, dtype=dtype)
    method = {
        "fill_linear": lambda x: x.fill("linear"),
        "fill_previous": lambda x: x.fill("previous"),
        "fill_next": lambda x: x.fill("next"),
        "fill_nearest": lambda x: x.fill("nearest"),
        "fill_zero": lambda x: x.fill("zero"),
        "fill_value": lambda x: x.fill("value", 7.5),
        "fill_spline": lambda x: x.fill("spline"),
        "differences": lambda x: x.differences(),
        "differences_3": lambda x: x.differences(3),
        "quotients": lambda x: x.quotients(2),
        "return_rates": lambda x: x.return_rates(),
    }[what]
    got, want = method(p), method(r)
    assert got.dtype == torch.float32 if dtype == np.float32 else True
    assert list(got.keys) == list(want.keys)
    np.testing.assert_allclose(got.series_values().numpy(),
                               np.asarray(want.series_values()), rtol=rtol,
                               atol=rtol)


def test_fill_rejects_unknown_methods_like_the_reference():
    p, r = _pair(SMALL)
    for x in (p, r):
        with pytest.raises(ValueError):
            x.fill("bogus")


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10),
                                        (np.float32, 2e-5)])
def test_autocorr_pacf_and_stats_match(dtype, rtol):
    rng = np.random.default_rng(9)
    v = rng.normal(size=(10, 80)).cumsum(axis=1).astype(dtype)
    v[3, 5:9] = nan
    keys = [f"k{i}" for i in range(10)]
    p, r = _pair(v, keys, dtype=dtype)
    pf, rf = p.fill("linear"), r.fill("linear")
    np.testing.assert_allclose(pf.autocorr(4).numpy(),
                               np.asarray(rf.autocorr(4)), rtol=rtol,
                               atol=rtol)
    np.testing.assert_allclose(pf.pacf(4).numpy(), np.asarray(rf.pacf(4)),
                               rtol=rtol, atol=rtol)
    ps, rs = p.series_stats(), r.series_stats()
    assert set(ps) == set(rs) == {"count", "mean", "stdev", "min", "max"}
    np.testing.assert_array_equal(ps["count"].numpy(), np.asarray(rs["count"]))
    for k in ("min", "max"):
        np.testing.assert_array_equal(ps[k].numpy(), np.asarray(rs[k]))
    for k in ("mean", "stdev"):
        np.testing.assert_allclose(ps[k].numpy(), np.asarray(rs[k]),
                                   rtol=rtol)


def test_stats_of_an_all_nan_row_match():
    p, r = _pair(_wide(), WIDE_KEYS)
    ps, rs = p.series_stats(), r.series_stats()
    for k in ("count", "mean", "stdev", "min", "max"):
        np.testing.assert_array_equal(ps[k].numpy()[2], np.asarray(rs[k])[2])


def test_to_folded_roundtrip():
    p, r = _pair(SMALL)
    fp = p.to_folded()
    assert isinstance(fp, FoldedPanel) and fp.shape == (3, 6)
    np.testing.assert_array_equal(unfold_panel(fp).numpy(),
                                  np.asarray(rlayout.unfold_panel(
                                      r.to_folded())))


# ---------------------------------------------------------------------------
# exits
# ---------------------------------------------------------------------------


def test_matrix_exits_are_bitwise():
    p, r = _pair(_wide(), WIDE_KEYS)
    (pd_, pv), (rd_, rv) = p.to_instants(), r.to_instants()
    np.testing.assert_array_equal(pd_, rd_)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(p.to_row_matrix().numpy(),
                                  np.asarray(r.to_row_matrix()))
    (pl, pm), (rl, rm) = p.to_indexed_row_matrix(), r.to_indexed_row_matrix()
    np.testing.assert_array_equal(pl, rl)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("exit_", ["to_instants_dataframe", "to_pandas",
                                   "to_observations_dataframe"])
def test_dataframe_exits_match(exit_):
    p, r = _pair(_wide(), WIDE_KEYS)
    pd.testing.assert_frame_equal(getattr(p, exit_)(), getattr(r, exit_)())


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------


def test_from_observations_matches():
    kw = dict(keys=["y", "x", "x", "y", "x"],
              timestamps=["2020-01-01", "2020-01-01", "2020-01-03",
                          "2020-01-04", "2020-01-04"],
              values=[10.0, 1.0, 3.0, 40.0, 4.0])
    p = port.from_observations(_index(pix, n=4), **kw, dtype=torch.float64,
                               device="cpu")
    r = ref.from_observations(_index(rix, n=4), **kw, dtype=jnp.float64)
    _same(p, r)
    assert list(p.keys) == ["x", "y"]  # sorted


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_from_observations_integer_keys_and_rounding(dtype):
    # integer keys take numpy's sort; float64 values round once to dtype
    rng = np.random.default_rng(4)
    n, t = 7, 9
    keys = np.repeat(rng.permutation(n) * 3, t)
    ts = np.datetime64("2020-01-01", "D") + np.tile(np.arange(t), n)
    vals = rng.normal(size=n * t) * 1e3 + 1e-9
    keep = rng.random(n * t) < 0.8
    tdtype = torch.float32 if dtype == np.float32 else torch.float64
    p = port.from_observations(_index(pix, n=t), keys[keep], ts[keep],
                               vals[keep], dtype=tdtype, device="cpu")
    r = ref.from_observations(_index(rix, n=t), keys[keep], ts[keep],
                              vals[keep], dtype=jnp.dtype(dtype))
    _same(p, r)
    assert p.dtype == tdtype


def test_from_observations_off_index_and_strict():
    kw = dict(keys=["x", "x"], timestamps=["2020-01-02", "2020-06-09"],
              values=[2.0, 99.0])
    p = port.from_observations(_index(pix, n=3), **kw, device="cpu")
    r = ref.from_observations(_index(rix, n=3), **kw)
    _same(p, r)
    for mod, lib, extra in ((port, pix, dict(device="cpu")), (ref, rix, {})):
        with pytest.raises(ValueError, match="not on the index"):
            mod.from_observations(_index(lib, n=3), ["x"], ["2020-06-09"],
                                  [99.0], strict=True, **extra)


@pytest.mark.parametrize("with_index", [True, False])
def test_from_dataframe_matches(with_index):
    _, r = _pair(_wide(), WIDE_KEYS)
    df = r.to_observations_dataframe()
    p = port.from_dataframe(df, _index(pix, n=40) if with_index else None,
                            dtype=torch.float64, device="cpu")
    rr = ref.from_dataframe(df, _index(rix, n=40) if with_index else None,
                            dtype=jnp.float64)
    _same(p, rr)


def test_from_series_dict_matches():
    series = dict(zip(KEYS, SMALL))
    p = port.from_series_dict(series, _index(pix), dtype=torch.float32,
                              device="cpu")
    r = ref.from_series_dict(series, _index(rix), dtype=jnp.float32)
    _same(p, r)


# ---------------------------------------------------------------------------
# the map_series memo and its counters
# ---------------------------------------------------------------------------

_SCALE = 2.0


class _Tr:
    def __init__(self, c):
        self.c = c

    def tr(self, v):
        return v * self.c


@pytest.fixture
def both_planes():
    pobs.enable()
    robs.enable()
    ppanel._BATCH_CACHE.clear()
    rpanel._BATCH_CACHE.clear()
    try:
        yield
    finally:
        pobs.disable()
        robs.disable()


def _counters(o):
    snap = o.snapshot()["counters"]
    return {k: v for k, v in snap.items() if k.startswith("panel.map_series")}


def test_memo_counters_move_as_the_reference(both_planes):
    global _SCALE
    p, r = _pair(SMALL)
    a, b = _Tr(2.0), _Tr(3.0)
    calls = [
        lambda x: x.map_series(lambda v: v * 2.125),
        lambda x: x.map_series(lambda v: v * 2.125),  # identical lambda: hit
        lambda x: x.map_series(lambda v: v * _SCALE),
        lambda x: x.map_series(a.tr),
        lambda x: x.map_series(b.tr),
        lambda x: x.map_series(a.tr),
        lambda x: x.map_series(lambda v, c=np.ones(1): v),  # unhashable
        lambda x: x.differences(1),
        lambda x: x.differences(1),
        lambda x: x.fill("previous"),
        lambda x: x.fill("linear"),  # the fused kernel: no memo
        lambda x: x.pacf(2),
        lambda x: x.lags(1),
    ]
    for i, call in enumerate(calls):
        if i == 3:
            _SCALE = 3.0  # a rebound global is a new entry
            for x in (p, r):
                got = x.map_series(lambda v: v * _SCALE)
                np.testing.assert_allclose(np.asarray(got["a"]),
                                           3 * np.asarray(SMALL[0]))
        for x in (p, r):
            call(x)
    _SCALE = 2.0
    assert _counters(pobs) == _counters(robs)
    assert _counters(pobs)["panel.map_series.cache_hits"] >= 3
    assert len(ppanel._BATCH_CACHE) == len(rpanel._BATCH_CACHE)


def test_memo_identity_rules_match_the_reference():
    for lib in (ppanel, rpanel):
        def call():
            return lib._cached_batched(lambda v: v * 2.125)

        arr = (torch.ones(2, 3) if lib is ppanel else jnp.ones((2, 3)))
        call()(arr)  # the first successful call populates the cache
        assert call() is call()

        def make(c):
            return lib._cached_batched(lambda v: v * c)

        assert make(2.0) is not make(3.0)
        assert lib._cached_batched(lambda v, c=2.0: v * c) is not (
            lib._cached_batched(lambda v, c=3.0: v * c))


def test_refused_function_leaves_no_cache_entry():
    p, _ = _pair(SMALL)
    before = len(ppanel._BATCH_CACHE)
    with pytest.raises(AttributeError):
        p.map_series(lambda v: v.fillna(0.0))  # pandas-only API
    with pytest.raises(RuntimeError, match="vmap"):
        p.map_series(lambda v: v if v.sum() > 0 else -v)  # data-dependent if
    assert len(ppanel._BATCH_CACHE) == before


# ---------------------------------------------------------------------------
# fits and forecasts through the chunk walk
# ---------------------------------------------------------------------------

PARAM_TOL = 4e-3  # tests/test_torch_chunked.py's ARIMA walk bar


def _arma_panel(b=16, t=120, seed=3):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i] + 0.3 * e[:, i - 1]
    return np.cumsum(y, axis=1)


@pytest.fixture(scope="module")
def fit_pair():
    y = _arma_panel()
    keys = [f"r{i}" for i in range(16)]
    p, r = _pair(y, keys, dtype=np.float32)
    kw = dict(chunk_rows=8, order=(1, 1, 1), max_iters=30)
    return y, p, r, p.fit("arima", **kw), r.fit("arima", **kw)


def test_fit_matches_the_reference(fit_pair):
    _, _, _, got, want = fit_pair
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    np.testing.assert_allclose(got.params, np.asarray(want.params),
                               rtol=PARAM_TOL, atol=PARAM_TOL)
    for k in ("chunk_rows_initial", "chunks_run", "status_counts",
              "align_mode"):
        assert got.meta[k] == want.meta[k], k


def test_fit_is_fit_chunked_bit_for_bit(fit_pair, tmp_path):
    y, p, _, got, _ = fit_pair
    direct = reliability.fit_chunked(arima.fit, torch.as_tensor(y),
                                     chunk_rows=8, order=(1, 1, 1),
                                     max_iters=30, device="cpu")
    for f in ("params", "neg_log_likelihood", "converged", "iters",
              "status"):
        np.testing.assert_array_equal(getattr(got, f), getattr(direct, f))
    jour = p.fit("arima", chunk_rows=8, order=(1, 1, 1), max_iters=30,
                 resilient=False, checkpoint_dir=str(tmp_path / "j"))
    jdirect = reliability.fit_chunked(
        arima.fit, torch.as_tensor(y), chunk_rows=8, order=(1, 1, 1),
        max_iters=30, resilient=False, device="cpu",
        checkpoint_dir=str(tmp_path / "k"))
    np.testing.assert_array_equal(jour.params, jdirect.params)
    assert jour.meta["journal"]["chunks_committed"] == 2


def test_fit_argument_errors_match():
    p, r = _pair(SMALL)
    for x in (p, r):
        with pytest.raises(ValueError, match="unknown model"):
            x.fit("nope")
        with pytest.raises(ValueError, match="source shape"):
            x.fit("arima", source=np.zeros((2, 6), np.float32))
    # shard=/mesh= forward to the multi-lane walk: bit for bit the
    # single-lane walk on the same chunk grid, and the reference's sharded
    # fit within the fit-parity bar
    pw, rw = _pair(_wide(), keys=WIDE_KEYS, dtype=np.float32)
    mesh = port.parallel.mesh.default_mesh(devices=[torch.device("cpu")] * 4)
    kw = dict(order=(1, 0, 0), max_iters=20, resilient=False)
    lanes = pw.fit("arima", mesh=mesh, **kw)
    one = pw.fit("arima", chunk_rows=3, **kw)
    np.testing.assert_array_equal(lanes.params, one.params)
    np.testing.assert_array_equal(lanes.status, one.status)
    assert lanes.meta["shards"]["n_shards"] == 4
    want = rw.fit("arima", shard=True, chunk_rows=3, **kw)
    np.testing.assert_array_equal(lanes.status, np.asarray(want.status))
    fin = np.isfinite(lanes.params).all(1)
    np.testing.assert_allclose(lanes.params[fin],
                               np.asarray(want.params)[fin],
                               rtol=4e-3, atol=4e-3)


def test_forecast_matches_the_reference(fit_pair):
    _, p, r, got_fit, want_fit = fit_pair
    got = p.forecast("arima", 5, got_fit, order=(1, 1, 1), chunk_rows=8)
    want = r.forecast("arima", 5, want_fit, order=(1, 1, 1), chunk_rows=8)
    np.testing.assert_array_equal(got.status, np.asarray(want.status))
    np.testing.assert_allclose(got.forecast, np.asarray(want.forecast),
                               rtol=2e-2, atol=2e-2)
    direct = forecasting.forecast_chunked(
        "arima", got_fit, p.series_values(), 5,
        model_kwargs={"order": (1, 1, 1)}, chunk_rows=8, device="cpu")
    np.testing.assert_array_equal(got.forecast, direct.forecast)


def test_auto_fit_matches_the_reference():
    y = _arma_panel(b=8, t=80, seed=11)
    p, r = _pair(y, [f"q{i}" for i in range(8)], dtype=np.float32)
    orders = [(1, 1, 0), (1, 1, 1)]
    got = p.auto_fit(orders, max_iters=25)
    want = r.auto_fit(orders, max_iters=25)
    np.testing.assert_array_equal(got.order_index,
                                  np.asarray(want.order_index))
    np.testing.assert_allclose(got.params, np.asarray(want.params),
                               rtol=PARAM_TOL, atol=PARAM_TOL)
    direct = auto.auto_fit(torch.as_tensor(y), orders, max_iters=25,
                           device="cpu")
    np.testing.assert_array_equal(got.params, direct.params)
    np.testing.assert_array_equal(got.order_index, direct.order_index)


def test_backtest_is_run_backtest(tmp_path):
    y = _arma_panel(b=4, t=60, seed=2)
    p, _ = _pair(y, [f"w{i}" for i in range(4)], dtype=np.float32)
    kw = dict(model_kwargs={"order": (1, 1, 0)},
              fit_kwargs={"method": "hannan-rissanen"}, n_windows=2)
    got = p.backtest("arima", 3, checkpoint_dir=str(tmp_path / "a"), **kw)
    direct = forecasting.run_backtest(torch.as_tensor(y), "arima", 3,
                                      checkpoint_dir=str(tmp_path / "b"),
                                      device="cpu", **kw)
    assert got.metrics == direct.metrics


# ---------------------------------------------------------------------------
# persistence, across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_csv_files_are_the_references(tmp_path, dtype):
    p, r = _pair(_wide(), WIDE_KEYS, dtype=dtype)
    p.save_csv(str(tmp_path / "p.csv"))
    r.save_csv(str(tmp_path / "r.csv"))
    assert (tmp_path / "p.csv").read_text() == (tmp_path / "r.csv").read_text()
    _same(port.TimeSeriesPanel.load_csv(str(tmp_path / "r.csv"),
                                        device="cpu"),
          ref.TimeSeriesPanel.load_csv(str(tmp_path / "p.csv")))
    with pytest.raises(ValueError, match="','"):
        port.TimeSeriesPanel(_index(pix), ["a,b", "c", "d"],
                             torch.zeros(3, 6)).save_csv(
                                 str(tmp_path / "bad.csv"))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_npz_files_read_across_packages(tmp_path, dtype):
    p, r = _pair(_wide(), WIDE_KEYS, dtype=dtype)
    p.save(str(tmp_path / "p.npz"))
    r.save(str(tmp_path / "r"))  # np.savez appends the suffix
    with np.load(tmp_path / "p.npz") as zp, np.load(tmp_path / "r.npz") as zr:
        assert zp.files == zr.files
        for k in zp.files:
            np.testing.assert_array_equal(zp[k], zr[k])
    _same(port.TimeSeriesPanel.load(str(tmp_path / "r"), device="cpu"), r)
    _same(p, ref.TimeSeriesPanel.load(str(tmp_path / "p.npz")))


@pytest.mark.parametrize("row_group_series", [16384, 5])
def test_parquet_files_read_across_packages(tmp_path, row_group_series):
    import pyarrow.parquet as pq

    p, r = _pair(_wide(), WIDE_KEYS, dtype=np.float32)
    p.save_parquet(str(tmp_path / "p.parquet"),
                   row_group_series=row_group_series)
    r.save_parquet(str(tmp_path / "r.parquet"),
                   row_group_series=row_group_series)
    tp, tr = (pq.read_table(tmp_path / f) for f in ("p.parquet",
                                                    "r.parquet"))
    assert tp.schema.equals(tr.schema, check_metadata=True)
    assert tp.column("key").to_pylist() == tr.column("key").to_pylist()
    np.testing.assert_array_equal(  # bit for bit, NaN where NaN
        np.asarray(tp.column("values").combine_chunks().flatten()),
        np.asarray(tr.column("values").combine_chunks().flatten()))
    assert (pq.ParquetFile(tmp_path / "p.parquet").metadata.num_row_groups
            == pq.ParquetFile(tmp_path / "r.parquet").metadata.num_row_groups)
    _same(port.TimeSeriesPanel.load_parquet(str(tmp_path / "r.parquet"),
                                            device="cpu"), r)
    _same(p, ref.TimeSeriesPanel.load_parquet(str(tmp_path / "p.parquet")))


def test_parquet_rejects_a_foreign_file(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "foreign.parquet")
    pq.write_table(pa.table({"x": [1, 2]}), path)
    with pytest.raises(ValueError, match="checkpoint"):
        port.TimeSeriesPanel.load_parquet(path, device="cpu")


def test_load_onto_a_mesh(tmp_path):
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib

    p, _ = _pair(_wide(), WIDE_KEYS)
    p.save(str(tmp_path / "m.npz"))
    m = meshlib.default_mesh(devices=[torch.device("cpu")] * 8)
    back = port.TimeSeriesPanel.load(str(tmp_path / "m.npz"), mesh=m)
    assert back.mesh is m and back.values.shape == (16, 40)
    assert back.keys.tolist() == p.keys.tolist()
    np.testing.assert_array_equal(back.series_values().numpy(),
                                  p.series_values().numpy())

"""The port's ensembles and backtest campaigns
(``forecasting/ensemble.py``, ``backtest.py``) against the reference.

``criterion_weights`` is the reference's function of the criteria;
``temperature=0`` returns the argmin winner's own forecast walk bit for
bit; a blended ensemble over the same auto-fit grid agrees with the
reference's.  A backtest campaign's metrics agree with the reference's
within 1e-5 relative; its own contracts (a crashed campaign resumes to
bitwise-identical metrics, a grown panel adopts the prior campaign's
windows under ``delta=True``) hold bitwise on the port, held here against
the port's own uninterrupted runs.  Panels are float32 on both sides
(``tests/conftest.py`` enables x64).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_timeseries_tpu import forecasting as ref_fc
from spark_timeseries_tpu.models import auto as ref_auto
from spark_timeseries_tpu_torch import forecasting as fc
from spark_timeseries_tpu_torch.models import auto
from spark_timeseries_tpu_torch.reliability import faultinject as fi

ORDERS = [(1, 0, 0), (0, 0, 1), (1, 0, 1)]
H = 4


def _panel(b=16, t=90, seed=7):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    for i in range(t):
        y[:, i] = (0.6 * y[:, i - 1] if i else 0.0) + e[:, i]
        if i:
            y[:, i] += 0.3 * e[:, i - 1]
    return y + 2.0


@pytest.fixture(scope="module")
def searches(tmp_path_factory):
    """One auto-fit search root per package over the same panel."""
    y = _panel()
    base = tmp_path_factory.mktemp("ens")
    proot, rroot = str(base / "port"), str(base / "ref")
    auto.auto_fit(torch.as_tensor(y), ORDERS, max_iters=15, chunk_rows=8,
                  checkpoint_dir=proot, device="cpu")
    ref_auto.auto_fit(jnp.asarray(y), ORDERS, max_iters=15, chunk_rows=8,
                      checkpoint_dir=rroot)
    return y, proot, rroot


@pytest.mark.parametrize("temperature", [0.0, 0.5, 1.0, 4.0])
def test_criterion_weights_match_reference(temperature):
    rng = np.random.default_rng(0)
    c = rng.normal(300.0, 3.0, (4, 50))
    c[1, :5] = np.inf
    c[:, 7] = np.inf
    c[2, 9] = np.nan
    c[3, 11] = c[0, 11]  # a tie
    want = ref_fc.criterion_weights(c, temperature)
    got = fc.criterion_weights(c, temperature)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64
    assert (got[:, 7] == 0).all()


def test_criterion_weights_reject_negative_temperature():
    with pytest.raises(ValueError):
        fc.criterion_weights(np.zeros((2, 3)), -1.0)


def test_temperature_zero_is_the_winner_bitwise(searches):
    y, proot, _ = searches
    kw = dict(chunk_rows=8, intervals=True, n_samples=32, device="cpu")
    ens = fc.ensemble_forecast(torch.as_tensor(y), H, auto_root=proot,
                               temperature=0.0, **kw)
    specs, ii, members, _ = fc.load_auto_members(proot)
    rows = np.arange(y.shape[0])
    assert (ens.order_index >= 0).all()
    # every member forecast is that order's own forecast walk; the
    # ensemble is a literal per-row gather of the winner's
    for g, spec in enumerate(specs):
        walk_g = fc.forecast_chunked(
            "arima", members[g], torch.as_tensor(y), H,
            model_kwargs={"order": spec.order, "include_intercept": ii},
            **kw)
        np.testing.assert_array_equal(ens.member_forecasts[g],
                                      walk_g.forecast)
        won = ens.order_index == g
        np.testing.assert_array_equal(ens.forecast[won],
                                      walk_g.forecast[won])
        np.testing.assert_array_equal(ens.lo[won], walk_g.lo[won])
        np.testing.assert_array_equal(ens.hi[won], walk_g.hi[won])
    winner = ens.member_forecasts[ens.order_index, rows]
    np.testing.assert_array_equal(ens.forecast, winner)
    res = auto.auto_fit(torch.as_tensor(y), ORDERS, max_iters=15,
                        chunk_rows=8, checkpoint_dir=proot, device="cpu")
    np.testing.assert_array_equal(ens.order_index, res.order_index)


@pytest.mark.parametrize("temperature", [0.0, 2.0])
def test_ensemble_matches_reference(searches, temperature):
    # both packages blend the SAME member fits (the reference search's),
    # so the comparison holds the criteria, weights, member forecast walks
    # and blend, not the two optimizers' stopping points
    y, _, rroot = searches
    specs, ii, members, _ = ref_fc.load_auto_members(rroot)
    kw = dict(orders=[s.order for s in specs], include_intercept=ii,
              members=members, chunk_rows=8, temperature=temperature,
              intervals=True, n_samples=32)
    want = ref_fc.ensemble_forecast(jnp.asarray(y), H, **kw)
    got = fc.ensemble_forecast(torch.as_tensor(y), H, device="cpu", **kw)
    np.testing.assert_array_equal(got.order_index, want.order_index)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-5)
    for f in ("forecast", "lo", "hi"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f)
    np.testing.assert_array_equal(got.status, want.status)


def test_fresh_member_fits(tmp_path):
    y = _panel(b=8, t=80, seed=9)
    ens = fc.ensemble_forecast(
        torch.as_tensor(y), 3, orders=[(1, 0, 0), (0, 0, 1)],
        temperature=1.0, chunk_rows=8, fit_kwargs={"max_iters": 15},
        checkpoint_dir=str(tmp_path / "fresh"), device="cpu")
    assert np.allclose(ens.weights.sum(0)[ens.order_index >= 0], 1.0)
    assert os.path.exists(str(tmp_path / "fresh" / "grid_00000"
                              / "manifest.json"))
    with pytest.raises(ValueError, match="seasonal"):
        fc.ensemble_forecast(torch.as_tensor(y), 3,
                             orders=[(1, 0, 0), (1, 0, 0, (1, 0, 0, 4))],
                             device="cpu")


# ---------------------------------------------------------------------------
# backtest campaigns
# ---------------------------------------------------------------------------

BT_KW = dict(model_kwargs={"order": (1, 0, 0)},
             fit_kwargs={"max_iters": 15}, chunk_rows=8)


@pytest.fixture(scope="module")
def bt_panel():
    return _panel(b=16, t=64, seed=5)


@pytest.mark.parametrize("intervals", [False, True])
def test_backtest_metrics_match_reference(bt_panel, intervals):
    # closed-form Hannan-Rissanen fits (warm windows keep their init):
    # the comparison holds the campaign, the warm start, the forecast
    # walk and the metrics at 1e-5; optimizer fits of the two packages
    # stop ~1e-4 apart, which the metrics would carry.  The draws take an
    # explicit seed: a fingerprint-derived one hashes the fitted params,
    # whose last bits differ between the packages
    kw = dict(BT_KW, n_windows=3, intervals=intervals, n_samples=16,
              seed=3, fit_kwargs={"method": "hannan-rissanen"})
    want = ref_fc.run_backtest(jnp.asarray(bt_panel), "arima", H, **kw)
    got = fc.run_backtest(torch.as_tensor(bt_panel), "arima", H,
                          device="cpu", **kw)
    assert [w["origin"] for w in got.windows] == \
        [w["origin"] for w in want.windows]
    assert [w["warm_start"] for w in got.windows] == \
        [w["warm_start"] for w in want.windows] == [False, True, True]
    assert set(got.metrics) == set(want.metrics)
    for key, v in want.metrics.items():
        if isinstance(v, list) and v and isinstance(v[0], float):
            np.testing.assert_allclose(got.metrics[key], v, rtol=1e-5,
                                       err_msg=key)
        else:
            assert got.metrics[key] == v, key


def test_backtest_resume_after_crash_is_bitwise(bt_panel, tmp_path):
    kw = dict(BT_KW, n_windows=3, intervals=True, n_samples=16,
              device="cpu")
    y = torch.as_tensor(bt_panel)
    clean = fc.run_backtest(y, "arima", H,
                            checkpoint_dir=str(tmp_path / "clean"), **kw)
    root = str(tmp_path / "crashed")
    # two windows of two 8-row chunks each: the crash lands in window 1
    with pytest.raises(fi.SimulatedCrash):
        fc.run_backtest(y, "arima", H, checkpoint_dir=root,
                        _journal_commit_hook=fi.crash_after_commits(3),
                        **kw)
    m = json.load(open(os.path.join(root, fc.BACKTEST_MANIFEST)))
    assert [w["index"] for w in m["windows"]] == [0]
    res = fc.run_backtest(y, "arima", H, checkpoint_dir=root, **kw)
    assert res.metrics == clean.metrics
    for a, b in zip(res.windows, clean.windows):
        assert a["digest"] == b["digest"]
    again = fc.run_backtest(y, "arima", H, checkpoint_dir=root, **kw)
    assert again.metrics == clean.metrics
    with pytest.raises(fc.StaleBacktestError):
        fc.run_backtest(y, "arima", H, checkpoint_dir=root,
                        **dict(kw, n_windows=2))


def test_delta_campaign_adopts_the_prior_windows(bt_panel, tmp_path):
    y = torch.as_tensor(bt_panel)
    d = str(tmp_path / "bt")
    prior = fc.run_backtest(y[:, :60].contiguous(), "arima", H,
                            origins=[40, 48, 56], checkpoint_dir=d,
                            device="cpu", **BT_KW)
    delta = fc.run_backtest(y, "arima", H, origins=[40, 48, 56, 60],
                            checkpoint_dir=d, delta=True, device="cpu",
                            **BT_KW)
    info = delta.meta["delta"]
    assert info["adopted"] == 3 and info["recomputed"] == 1
    assert info["prior_n_time"] == 60
    assert info["prior_campaign_hash"] == prior.meta["campaign_hash"]
    assert delta.meta["window_classes"]["counts"]["adopted"] == 3
    by_idx = {w["index"]: w for w in json.load(open(os.path.join(
        d, fc.BACKTEST_MANIFEST)))["windows"]}
    for pw in prior.windows:
        assert by_idx[pw["index"]]["digest"] == pw["digest"]
        assert by_idx[pw["index"]]["window_class"] == "adopted"
    fresh = fc.run_backtest(y, "arima", H, origins=[40, 48, 56, 60],
                            checkpoint_dir=str(tmp_path / "fresh"),
                            device="cpu", **BT_KW)
    for dw, fw in zip(delta.windows, fresh.windows):
        assert dw["digest"] == fw["digest"]
    assert delta.metrics == fresh.metrics
    with pytest.raises(fc.StaleBacktestError, match="delta=True"):
        fc.run_backtest(torch.cat([y, y[:, -2:]], dim=1), "arima", H,
                        origins=[40, 48, 56, 62], checkpoint_dir=d,
                        device="cpu", **BT_KW)


def test_backtest_refuses_the_unported_paths(bt_panel, tmp_path):
    # the paths once refused now run: server= routes every window's
    # forecast through a resident FitServer and mesh= runs the fits on
    # the multi-lane walk, each with metrics equal to the local
    # campaign's as JSON with sorted keys (the reference's contract,
    # tests/_fleet_worker.py), and the reference's server campaign
    # scores within the closed-form fits' parity bar
    from spark_timeseries_tpu import serving as rserving
    from spark_timeseries_tpu_torch import serving
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib

    y = torch.as_tensor(bt_panel)
    kw = dict(BT_KW, fit_kwargs={"method": "hannan-rissanen"})
    local = fc.run_backtest(y, "arima", H, device="cpu", **kw)
    with serving.FitServer(str(tmp_path / "srv"), cell_rows=8,
                           autotune=False, device="cpu") as srv:
        served = fc.run_backtest(y, "arima", H, server=srv, device="cpu",
                                 **kw)
    assert (json.dumps(served.metrics, sort_keys=True)
            == json.dumps(local.metrics, sort_keys=True))
    assert srv.health()["counters"]["completed"] == len(local.windows)
    mesh = meshlib.default_mesh(devices=[torch.device("cpu")] * 2)
    lanes = fc.run_backtest(y, "arima", H, mesh=mesh, device="cpu", **kw)
    assert (json.dumps(lanes.metrics, sort_keys=True)
            == json.dumps(local.metrics, sort_keys=True))
    with rserving.FitServer(str(tmp_path / "rsrv"), cell_rows=8,
                            autotune=False) as rsrv:
        want = ref_fc.run_backtest(bt_panel, "arima", H, server=rsrv,
                                   **kw)
    assert set(served.metrics) == set(want.metrics)
    for key, v in want.metrics.items():
        if isinstance(v, list) and v and isinstance(v[0], float):
            np.testing.assert_allclose(served.metrics[key], v, rtol=1e-5,
                                       err_msg=key)
    with pytest.raises(ValueError):
        fc.run_backtest(y, "arima", 0, device="cpu", **BT_KW)

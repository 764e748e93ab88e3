"""The port's tick loop (``serving.TickLoop``) against the reference's
(``tests/test_streaming.py``: ``TestTickLoop`` and ``TestProfileEviction``).

Against the reference, on copies of the same npz shard directory and the
same tick batches: each cycle's durable record (stage progression,
``t_before``, tick digest, delta class counts, published geometry and
status counts) is the reference's, and the published forecasts agree
within the ARIMA fit-parity bar.  The port's own contracts, bit for bit:
a cycle that crashes after its fit committed (mid-publish) resumes to the
bytes an uninterrupted loop publishes, and a rewound cycle republishes the
same bytes.  The tenant-profile eviction cases run through both stores.
"""

import gc
import json
import os

import numpy as np
import pytest

from spark_timeseries_tpu.reliability import source as rsource
from spark_timeseries_tpu.serving import profiles as rprofiles
from spark_timeseries_tpu.serving import tickloop as rtick
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from spark_timeseries_tpu_torch.reliability import source as source_mod
from spark_timeseries_tpu_torch.serving import profiles
from spark_timeseries_tpu_torch.serving import tickloop as tick

B, T0, TICKS = 24, 48, 4


@pytest.fixture(autouse=True)
def _no_pool_outlives_its_test():
    """A staging pool registers with the process-wide peak-memory probe
    while it lives; one left in cyclic garbage would show in the next
    test's journal entries (``peak_staging_pool_bytes``)."""
    yield
    gc.collect()


def _panel(b=B, t=T0, seed=7):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.6 * y[:, i - 1] + e[:, i]
    return y


def _ticks(n=2):
    rng = np.random.default_rng(5)
    return [rng.normal(scale=0.5, size=(B, TICKS)).astype(np.float32)
            for _ in range(n)]


def _loop(mod, root, data, **kw):
    extra = {"device": "cpu"} if mod is tick else {}
    return mod.TickLoop(str(root), str(data), model="arima",
                        model_kwargs={"order": (1, 0, 0)},
                        fit_kwargs={"max_iters": 15}, horizon=4,
                        chunk_rows=8, seed=11, **extra, **kw)


@pytest.fixture(scope="module")
def loops(tmp_path_factory):
    td = tmp_path_factory.mktemp("tick")
    out = {}
    for name, mod, src in (("port", tick, source_mod), ("ref", rtick,
                                                         rsource)):
        data = td / f"data_{name}"
        src.write_npz_shards(str(data), _panel(), 8)
        loop = _loop(mod, td / f"root_{name}", data)
        out[name] = (loop, [loop.run_cycle(t) for t in _ticks()], str(data))
    return out


def test_cycles_match_reference(loops):
    (pl, pres, pdata), (rl, rres, _) = loops["port"], loops["ref"]
    assert [r.cycle for r in pres] == [0, 1]
    keep = ("kind", "stage", "cycle", "t_before", "n_ticks", "ticks_digest",
            "delta_counts", "fit_status_counts")
    for p, r in zip(pres, rres):
        assert {k: p.meta.get(k) for k in keep} == \
            {k: r.meta.get(k) for k in keep}
        for k in ("rows", "pack_width", "status_counts"):
            assert p.meta["published"][k] == r.meta["published"][k], k
        assert set(p.meta["walls"]) == {"append_s", "fit_s", "publish_s"}
    assert pres[1].meta["t_before"] == T0 + TICKS
    assert source_mod.as_source(pdata).shape[1] == T0 + 2 * TICKS
    assert pres[1].meta["delta_counts"]["warm"] == 3
    got, glo, ghi = pl.published_forecast()
    want, _, _ = rl.published_forecast()
    assert got.shape == (B, 4) and glo is None and ghi is None
    np.testing.assert_allclose(got, np.asarray(want), rtol=4e-3, atol=4e-3)
    pm = json.load(open(os.path.join(pl.root, tick.TICKLOOP_MANIFEST)))
    rm = json.load(open(os.path.join(rl.root, rtick.TICKLOOP_MANIFEST)))
    assert pm["config"] == rm["config"] and pm["n_rows"] == rm["n_rows"]


def test_reopen_and_rejections(loops):
    loop, _, data = loops["port"]
    reopened = _loop(tick, loop.root, data)
    assert reopened.resume() is None
    assert reopened.published_forecast()[0].shape == (B, 4)
    with pytest.raises(tick.TickLoopError, match="config"):
        tick.TickLoop(loop.root, data, model="arima",
                      model_kwargs={"order": (1, 0, 0)},
                      fit_kwargs={"max_iters": 15}, horizon=9,
                      chunk_rows=8, seed=11, device="cpu")
    with pytest.raises(tick.TickLoopError, match="batch"):
        reopened.run_cycle(np.zeros((7, 4), np.float32))


def test_crash_after_the_fit_commit_resumes_bitwise(loops, tmp_path,
                                                    monkeypatch):
    """Cycle 1 dies after its refit committed, inside the publish walk;
    the reopened loop finishes it from the recorded ticks and publishes
    the bytes the uninterrupted loop published."""
    want_loop = loops["port"][0]
    data = tmp_path / "data"
    source_mod.write_npz_shards(str(data), _panel(), 8)
    loop = _loop(tick, tmp_path / "root", data)
    t0, t1 = _ticks()
    loop.run_cycle(t0)
    real = tick.walk_mod.forecast_chunked

    def crashing(*a, **kw):
        raise fi.SimulatedCrash("killed mid-publish")

    monkeypatch.setattr(tick.walk_mod, "forecast_chunked", crashing)
    with pytest.raises(fi.SimulatedCrash):
        loop.run_cycle(t1)
    m = json.load(open(os.path.join(loop.root, "cycle_00001",
                                    tick.CYCLE_MANIFEST)))
    assert m["stage"] == "fitted"
    monkeypatch.setattr(tick.walk_mod, "forecast_chunked", real)
    resumed = _loop(tick, tmp_path / "root", data).resume()
    assert resumed is not None and resumed.meta["stage"] == "published"
    for c in (0, 1):
        got = loop.published_forecast(cycle=c)[0]
        want = want_loop.published_forecast(cycle=c)[0]
        np.testing.assert_array_equal(got, want)


def test_stage_replay_republishes_same_bytes(loops):
    loop, results, data = loops["port"]
    before = loop.published_forecast(cycle=1)[0]
    mp = results[1].manifest_path
    m = json.load(open(mp))
    m["stage"], m["walls"] = "ticked", {}
    m.pop("published", None)
    with open(mp, "w") as f:
        json.dump(m, f)
    width0 = source_mod.as_source(data).shape[1]
    r = loop.resume()
    assert r is not None and r.meta["stage"] == "published"
    assert source_mod.as_source(data).shape[1] == width0
    np.testing.assert_array_equal(loop.published_forecast(cycle=1)[0],
                                  before)


# -- tenant-profile eviction ----------------------------------------------------


def _update(store, tenant):
    store.update(
        tenant, values=np.ones((4, 16), np.float32), orders=[(1, 0, 0)],
        order_index=np.zeros(4, np.int32),
        params=np.ones((4, 3), np.float32),
        criterion=np.zeros(4, np.float32), status=np.zeros(4, np.int8),
        cfg_key="k", criterion_name="aicc", include_intercept=True,
        route="new")


@pytest.mark.parametrize("mod", [profiles, rprofiles],
                         ids=["port", "ref"])
def test_profile_eviction_matches_reference(mod, tmp_path):
    clock = {"t": 0.0}
    store = mod.TenantProfileStore(str(tmp_path / "age"), max_age_s=100.0,
                                   clock=lambda: clock["t"])
    _update(store, "a")
    clock["t"] = 50.0
    _update(store, "b")
    clock["t"] = 150.0
    assert store.evict() == ["a"] and store.tenants() == ["b"]
    clock["t"] = 0.0
    count = mod.TenantProfileStore(str(tmp_path / "n"), max_profiles=2,
                                   clock=lambda: clock["t"])
    for i, t in enumerate("abc"):
        clock["t"] = float(i)
        _update(count, t)
    assert count.tenants() == ["b", "c"]
    calls = {"n": 0}

    def fence():
        calls["n"] += 1

    clock["t"] = 0.0
    fenced = mod.TenantProfileStore(str(tmp_path / "f"), max_age_s=10.0,
                                    fence=fence, clock=lambda: clock["t"])
    _update(fenced, "a")
    n0 = calls["n"]
    clock["t"] = 5.0
    assert fenced.evict() == [] and calls["n"] == n0
    clock["t"] = 20.0
    assert fenced.evict() == ["a"] and calls["n"] == n0 + 1
    free = mod.TenantProfileStore(str(tmp_path / "u"))
    _update(free, "a")
    assert free.evict(now=1e18) == [] and free.tenants() == ["a"]

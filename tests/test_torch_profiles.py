"""The port's tenant profiles (``serving.TenantProfileStore``) and the
server's warm routing against the reference's
(``tests/test_warm_routing.py``: ``TestProfileStore`` and
``TestServingWarmRouting``).

Against the reference: every classification of the store's matrix (stable,
drifted, new on row count / config / a shorter panel, another tenant), the
stability counting, the torn-bytes and fenced-write behaviour, and the
config key — each case run through both stores — and the profile FILES:
one written by either package classifies the same in the other.  The
server's route ladder (new → stable → drifted, and the cold exact mode)
runs through the port's ``FitServer`` on the CPU; its exact mode is bit
for bit the direct ``models.auto.auto_fit`` call, and a profile survives a
server restart.
"""

import gc
import os

import numpy as np
import pytest

from spark_timeseries_tpu.reliability.journal import \
    FencedError as RFencedError
from spark_timeseries_tpu.serving import profiles as rprofiles
from spark_timeseries_tpu_torch import serving
from spark_timeseries_tpu_torch.models import auto
from spark_timeseries_tpu_torch.reliability.journal import FencedError
from spark_timeseries_tpu_torch.serving import profiles
from spark_timeseries_tpu_torch.serving.server import _align_mode_host

MODS = {"port": (profiles, FencedError), "ref": (rprofiles, RFencedError)}


@pytest.fixture(autouse=True)
def _no_pool_outlives_its_test():
    """A staging pool registers with the process-wide peak-memory probe
    while it lives; one left in cyclic garbage would show in the next
    test's journal entries (``peak_staging_pool_bytes``)."""
    yield
    gc.collect()


def make_ar_panel(b=16, t=96, seed=5, phi=0.6):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    for i in range(1, t):
        y[:, i] = phi * y[:, i - 1] + e[:, i]
    return y


def _store_update(store, tenant, y, cfg, *, winner=(1, 0, 0), route="new"):
    b = y.shape[0]
    return store.update(
        tenant, values=y, orders=[list(winner), [0, 0, 1]],
        order_index=np.zeros(b, np.int32),
        params=np.full((b, 3), 0.5, np.float32),
        criterion=np.full(b, 1.0), status=np.zeros(b, np.int8),
        cfg_key=cfg, criterion_name="aicc", include_intercept=True,
        route=route)


def _matrix(store, y):
    y_more = np.concatenate([y, y[:, -4:]], axis=1)
    return [store.classify("t", v, c)[0] for v, c in (
        (y, "cfg"), (y_more, "cfg"), (y + np.float32(0.25), "cfg"),
        (y[:2], "cfg"), (y, "other-cfg"), (y[:, :16], "cfg"))] + [
        store.classify("u", y, "cfg")[0]]


@pytest.mark.parametrize("pkg", sorted(MODS))
def test_classification_matrix_matches_reference(pkg, tmp_path):
    mod, _ = MODS[pkg]
    y = make_ar_panel(b=4, t=32)
    store = mod.TenantProfileStore(str(tmp_path))
    assert store.classify("t", y, "cfg") == ("new", None)
    _store_update(store, "t", y, "cfg")
    route, prof = store.classify("t", y, "cfg")
    assert route == "stable" and prof["passes"] == 1
    assert _matrix(store, y) == ["stable", "stable", "drifted", "new",
                                 "new", "new", "new"]


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_profile_files_read_across_packages(writer, reader, tmp_path):
    y = make_ar_panel(b=4, t=32)
    _store_update(MODS[writer][0].TenantProfileStore(str(tmp_path)), "t",
                  y, "cfg")
    other = MODS[reader][0].TenantProfileStore(str(tmp_path))
    assert _matrix(other, y) == _matrix(
        MODS[writer][0].TenantProfileStore(str(tmp_path)), y)
    a = other.load("t")
    b = MODS[writer][0].TenantProfileStore(str(tmp_path)).load("t")
    for k in ("orders", "order_index", "params", "criterion", "status"):
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pkg", sorted(MODS))
def test_stability_counts_order_tuples(pkg, tmp_path):
    store = MODS[pkg][0].TenantProfileStore(str(tmp_path))
    y = make_ar_panel(b=4, t=32)
    assert _store_update(store, "t", y, "cfg")["stability"] == 0
    p = _store_update(store, "t", y, "cfg", route="stable")
    assert p["stability"] == 1 and p["passes"] == 2
    p = _store_update(store, "t", y, "cfg", winner=(2, 0, 0))
    assert p["stability"] == 0 and p["passes"] == 3
    assert _store_update(store, "t", y, "cfg2",
                         winner=(2, 0, 0))["stability"] == 0


@pytest.mark.parametrize("pkg", sorted(MODS))
def test_torn_bytes_and_fenced_writes(pkg, tmp_path):
    mod, fenced = MODS[pkg]
    y = make_ar_panel(b=4, t=32)
    store = mod.TenantProfileStore(str(tmp_path / "a"))
    _store_update(store, "t", y, "cfg")
    with open(store.path("t"), "wb") as f:
        f.write(b"not an npz")
    assert store.load("t") is None
    assert store.classify("t", y, "cfg") == ("new", None)
    assert store.tenants() == []
    good = mod.TenantProfileStore(str(tmp_path / "b"))
    _store_update(good, "t", y, "cfg")
    with open(good.path("t"), "rb") as f:
        before = f.read()

    def fence():
        raise fenced("stale token")

    zombie = mod.TenantProfileStore(str(tmp_path / "b"), fence=fence)
    with pytest.raises(fenced):
        _store_update(zombie, "t", y, "cfg", winner=(2, 0, 0))
    with open(good.path("t"), "rb") as f:
        assert f.read() == before
    with pytest.raises(fenced):
        _store_update(zombie, "u", y, "cfg")
    assert not os.path.exists(zombie.path("u"))


def test_config_key_matches_reference():
    for kw in ({"max_iters": 20, "criterion": "aicc"},
               {"criterion": "aicc", "max_iters": 20}, {"max_iters": 25},
               {"orders": [[1, 0, 0]], "stepwise": True}):
        assert profiles.config_key(kw) == rprofiles.config_key(kw)
    assert profiles.config_key({"max_iters": 20}) != \
        profiles.config_key({"max_iters": 25})


# -- the server's route ladder --------------------------------------------------


AUTO_KW = dict(max_iters=20, stepwise_max_passes=2, stepwise_max_order=1)


def _server(root):
    return serving.FitServer(root, cell_rows=8, autotune=False,
                             device="cpu")


def test_route_ladder_and_exact_mode(tmp_path):
    y = make_ar_panel(b=8, seed=9)
    y2 = y + np.float32(0.5)
    root = str(tmp_path / "srv")
    with _server(root) as srv:
        r1 = srv.submit("acme", y, "panel_auto", warm_routing=True,
                        **AUTO_KW).result(timeout=300)
        r2 = srv.submit("acme", y, "panel_auto", warm_routing=True,
                        **AUTO_KW).result(timeout=300)
        r3 = srv.submit("acme", y2, "panel_auto", warm_routing=True,
                        **AUTO_KW).result(timeout=300)
        cold = srv.submit("acme", y, "panel_auto", warm_routing=False,
                          orders=[(1, 0, 0), (0, 0, 1)],
                          max_iters=20).result(timeout=300)
        h = srv.health()["counters"]
    a1, a2, a3 = (r.meta["auto"] for r in (r1, r2, r3))
    assert [a1["route"], a2["route"], a3["route"]] == \
        ["new", "stable", "drifted"]
    assert a2["orders"] == a1["orders"]
    assert a2["order_index"] == a1["order_index"]
    assert np.allclose(r2.neg_log_likelihood, r1.neg_log_likelihood,
                       rtol=1e-4, atol=1e-3, equal_nan=True)
    w1 = sorted({tuple(a1["orders"][g]) for g in a1["order_index"]
                 if g >= 0})
    assert [tuple(o) for o in a3["orders"][:len(w1)]] == w1
    assert (h["route_new"], h["route_stable"], h["route_drifted"],
            h["route_cold"], h["profile_updates"]) == (1, 1, 1, 1, 3)
    ref = auto.auto_fit(y, [(1, 0, 0), (0, 0, 1)], max_iters=20,
                        chunk_rows=8, resilient=False, policy="impute",
                        align_mode=_align_mode_host(y), device="cpu")
    for f in ("params", "neg_log_likelihood", "converged", "iters",
              "status"):
        np.testing.assert_array_equal(getattr(cold, f),
                                      np.asarray(getattr(ref, f)), f)
    assert cold.meta["auto"]["route"] == "cold"
    assert cold.meta["auto"]["order_index"] == \
        [int(v) for v in np.asarray(ref.order_index)]
    # a restarted server on the root reads the durable profile
    with _server(root) as srv:
        r4 = srv.submit("acme", y2, "panel_auto", warm_routing=True,
                        **AUTO_KW).result(timeout=300)
    assert r4.meta["auto"]["route"] == "stable"
    assert r4.meta["auto"]["order_index"] == a3["order_index"]


def test_warm_routing_rejected_off_the_auto_model(tmp_path):
    with _server(str(tmp_path)) as srv:
        with pytest.raises(ValueError, match="warm_routing"):
            srv.submit("t", make_ar_panel(b=8), "arima", warm_routing=True,
                       order=(1, 0, 0))

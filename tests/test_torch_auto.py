"""The port's order search (``models/auto.py``) against the reference.

Criteria and selection are held against ``criterion_matrix`` /
``select_orders`` on the same stacks (a tie breaks to the earlier grid
entry; a row with no finite criterion gets order -1 and its worst
status).  The searches run on ``test_auto.py``'s known panel (AR(1),
MA(1) and ARIMA(1,1,0) blocks): the exhaustive per-order (``fuse=1``)
and fused searches, the winners economy and the stepwise search select
the reference's orders, with params and criteria at the reference's own
fused-vs-per-order bars.  The stepwise search is compared with the
reference's output directly (the reference's own stepwise contract test
fails on this tree).  A crashed search resumes to the uninterrupted bits,
and ``auto_manifest.json`` carries the reference's keys.  Panels are
float32 on both sides (``tests/conftest.py`` enables x64).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spark_timeseries_tpu.models import auto as ref_auto
from spark_timeseries_tpu_torch.models import auto
from spark_timeseries_tpu_torch.parallel import mesh as meshlib
from spark_timeseries_tpu_torch.reliability import faultinject as fi
from test_auto import KNOWN_ORDERS, make_known_panel

KW = dict(max_iters=30)


def _ref(y, orders, **kw):
    return ref_auto.auto_fit(jnp.asarray(y), orders, **KW, **kw)


def _port(y, orders, **kw):
    return auto.auto_fit(torch.as_tensor(y), orders, device="cpu", **KW,
                         **kw)


@pytest.fixture(scope="module")
def panel():
    return make_known_panel()


@pytest.fixture(scope="module")
def ref_runs(panel):
    """The reference's searches, once for the module."""
    return {
        "fuse1": _ref(panel, KNOWN_ORDERS, fuse=1),
        "fused": _ref(panel, KNOWN_ORDERS),
        "winners": _ref(panel, KNOWN_ORDERS, stage2="winners",
                        stage1_iters=6),
        "stepwise": _ref(panel, None, stepwise=True, stepwise_max_order=1),
    }


def _close(port, ref, *, params_tol):
    np.testing.assert_array_equal(port.order_index,
                                  np.asarray(ref.order_index))
    np.testing.assert_allclose(port.params, np.asarray(ref.params),
                               rtol=params_tol, atol=params_tol)
    np.testing.assert_allclose(port.criterion, np.asarray(ref.criterion),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(port.neg_log_likelihood,
                               np.asarray(ref.neg_log_likelihood),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(port.status, np.asarray(ref.status))


# ---------------------------------------------------------------------------
# criteria and selection
# ---------------------------------------------------------------------------

GRID = [(1, 0, 0), (0, 0, 1), (1, 1, 1), (2, 0, 1, (1, 0, 0, 4))]


def _stacks(seed=0, b=40):
    rng = np.random.default_rng(seed)
    nll = rng.normal(100.0, 20.0, (len(GRID), b)).astype(np.float32)
    nll[1, :3] = np.nan  # ineligible cells
    nll[:, 5] = np.nan  # a row with no finite criterion anywhere
    nll[2, 6] = np.inf
    nv = rng.integers(0, 120, b).astype(np.int32)
    nv[7] = 3  # degenerate denominators
    return nll, nv


@pytest.mark.parametrize("criterion", auto.CRITERIA)
def test_criterion_matrix_matches_reference(criterion):
    nll, nv = _stacks()
    want = np.asarray(ref_auto.criterion_matrix(
        GRID, jnp.asarray(nll), jnp.asarray(nv), criterion=criterion))
    got = auto.criterion_matrix(GRID, nll, nv, criterion=criterion).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6)


def _results(nll, seed=1):
    rng = np.random.default_rng(seed)
    b = nll.shape[1]
    out = []
    for g, spec in enumerate(auto.normalize_orders(GRID)):
        k = spec.n_params(True)
        out.append(auto.FitResult(
            rng.normal(size=(b, k)).astype(np.float32), nll[g],
            rng.random(b) > 0.3, rng.integers(1, 30, b).astype(np.int32),
            rng.integers(0, 3, b).astype(np.int8)))
    return out


@pytest.mark.parametrize("criterion", auto.CRITERIA)
def test_select_orders_matches_reference(criterion):
    nll, nv = _stacks()
    res = _results(nll)
    want = ref_auto.select_orders(GRID, res, nv, criterion=criterion)
    got = auto.select_orders(GRID, res, torch.as_tensor(nv),
                             criterion=criterion)
    for key in ("order_index", "params", "converged", "iters", "status",
                "counts"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    for key in ("neg_log_likelihood", "criterion"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=1e-6, err_msg=key)
    # the all-NaN row: no order, the worst status on its grid
    assert got["order_index"][5] == -1
    assert got["status"][5] == max(int(r.status[5]) for r in res)
    assert np.isnan(got["params"][5]).all()


def test_tie_breaks_to_the_earlier_grid_entry():
    # (1,0,0) and (0,0,1) have the same k: equal nll ties under AIC
    nll, nv = _stacks()
    nll[1] = nll[0]
    res = _results(nll)
    want = ref_auto.select_orders(GRID[:2], res[:2], nv, criterion="aic")
    got = auto.select_orders(GRID[:2], res[:2], nv, criterion="aic")
    np.testing.assert_array_equal(got["order_index"],
                                  np.asarray(want["order_index"]))
    fin = np.isfinite(nll[0])
    assert (got["order_index"][fin] == 0).all()
    # the rule the selection leans on: torch.argmin takes the first min
    c = torch.tensor([[1.0, 2.0, 3.0], [1.0, 0.5, 3.0], [1.0, 0.5, 3.0]])
    assert torch.argmin(c, dim=0).tolist() == [0, 1, 0]


def test_panel_n_valid_matches_reference(panel):
    y = panel.copy()
    y[0, :5] = np.nan
    y[1, -7:] = np.nan
    y[2] = np.nan
    y[3, 10:20] = np.nan
    want = np.asarray(ref_auto.panel_n_valid(jnp.asarray(y)))
    np.testing.assert_array_equal(auto.panel_n_valid(torch.as_tensor(y)),
                                  want)
    np.testing.assert_array_equal(auto.panel_n_valid(y), want)


def test_fusion_groups_and_diff_hits_match_reference():
    grid = [(1, 0, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (1, 1, 1)]
    for fuse in ("auto", 1, 2):
        assert auto.fusion_groups(grid, fuse) == \
            ref_auto.fusion_groups(grid, fuse)
        specs = auto.normalize_orders(grid)
        groups = auto.fusion_groups(grid, fuse)
        assert auto._grid_diff_cache_hits(specs, groups) == \
            ref_auto._grid_diff_cache_hits(
                ref_auto.normalize_orders(grid), groups)


# ---------------------------------------------------------------------------
# the searches
# ---------------------------------------------------------------------------


def test_exhaustive_per_order_matches_reference(panel, ref_runs):
    _close(_port(panel, KNOWN_ORDERS, fuse=1), ref_runs["fuse1"],
           params_tol=1e-2)


def test_fused_matches_reference_and_per_order(panel, ref_runs):
    res_f = _port(panel, KNOWN_ORDERS)
    _close(res_f, ref_runs["fused"], params_tol=1e-2)
    res_1 = _port(panel, KNOWN_ORDERS, fuse=1)
    np.testing.assert_array_equal(res_f.order_index, res_1.order_index)
    am = res_f.meta["auto_fit"]
    assert [g["orders"] for g in am["fusion_groups"]] == [[0, 1], [2]]
    assert am["diff_cache_hits"] == \
        ref_runs["fused"].meta["auto_fit"]["diff_cache_hits"] == 1


@pytest.mark.parametrize("fuse", ["auto", 1])
def test_winners_matches_reference(panel, ref_runs, fuse):
    res = _port(panel, KNOWN_ORDERS, stage2="winners", stage1_iters=6,
                fuse=fuse)
    ref = ref_runs["winners"]
    np.testing.assert_array_equal(res.order_index,
                                  np.asarray(ref.order_index))
    np.testing.assert_allclose(res.params, np.asarray(ref.params),
                               rtol=1e-2, atol=1e-2)
    am = res.meta["auto_fit"]
    assert am["stage2"] == "winners" and am["stage1_iters"] == 6
    assert sum(o["stage2_rows"] for o in am["orders"]) == panel.shape[0]


def test_stepwise_matches_reference_output(panel, ref_runs):
    # capped at p, q <= 1: the (2, d, 2) neighbours a cap of 2 admits are
    # overparameterized on these AR(1)/MA(1) blocks, and their CSS
    # surfaces have several optima that the two packages' float32
    # optimizers reach differently (criteria 3-10 apart on a few rows)
    res = _port(panel, None, stepwise=True, stepwise_max_order=1)
    ref = ref_runs["stepwise"]
    assert res.orders == tuple(
        auto.OrderSpec(tuple(s.order), s.seasonal) for s in ref.orders)
    np.testing.assert_array_equal(res.order_index,
                                  np.asarray(ref.order_index))
    # params and criteria where both optimizers converged (a weakly
    # identified ARMA row that stops at the budget may stop elsewhere in a
    # flat valley; its selection still agrees)
    both = res.converged & np.asarray(ref.converged)
    assert both.mean() > 0.5
    np.testing.assert_allclose(res.params[both], np.asarray(ref.params)[both],
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(res.criterion[both],
                               np.asarray(ref.criterion)[both],
                               rtol=1e-3, atol=1e-3)
    sw, rsw = res.meta["auto_fit"]["stepwise"], \
        ref.meta["auto_fit"]["stepwise"]
    assert [p["orders"] for p in sw["passes"]] == \
        [p["orders"] for p in rsw["passes"]]
    assert sw["converged"] == rsw["converged"]


@pytest.mark.parametrize("fuse", ["auto", 1])
def test_crash_resume_is_bitwise(panel, tmp_path, fuse):
    kw = dict(chunk_rows=8, fuse=fuse)
    clean = _port(panel, KNOWN_ORDERS, **kw)
    root = str(tmp_path / "search")
    with pytest.raises(fi.SimulatedCrash):
        _port(panel, KNOWN_ORDERS, checkpoint_dir=root,
              _journal_commit_hook=fi.crash_after_commits(2), **kw)
    res = _port(panel, KNOWN_ORDERS, checkpoint_dir=root, **kw)
    for f in ("params", "neg_log_likelihood", "converged", "iters",
              "status", "order_index", "criterion"):
        np.testing.assert_array_equal(getattr(res, f), getattr(clean, f),
                                      err_msg=f)


def test_auto_manifest_has_reference_keys(panel, tmp_path):
    proot, rroot = str(tmp_path / "port"), str(tmp_path / "ref")
    _port(panel, KNOWN_ORDERS, checkpoint_dir=proot)
    _ref(panel, KNOWN_ORDERS, checkpoint_dir=rroot)
    pm = json.load(open(os.path.join(proot, "auto_manifest.json")))
    rm = json.load(open(os.path.join(rroot, "auto_manifest.json")))
    assert set(pm) == set(rm)
    assert set(pm["auto_fit"]) == set(rm["auto_fit"])
    assert [set(o) for o in pm["auto_fit"]["orders"]] == \
        [set(o) for o in rm["auto_fit"]["orders"]]
    assert pm["grid_dirs"] == rm["grid_dirs"]
    assert pm["auto_fit"]["fusion_groups"] == rm["auto_fit"]["fusion_groups"]
    assert pm["auto_fit"]["selection_counts"] == \
        rm["auto_fit"]["selection_counts"]


def test_argument_errors_match_reference(panel):
    for kw in (dict(criterion="hqic"), dict(stage2="half"),
               dict(stepwise=True, stage2="winners"),
               dict(fuse=0), dict(orders=[(1, 0, 0), (1, 0, 0)]),
               dict(orders=[(1, 0, 0), (0, 0, 1)], backend="scan")):
        orders = kw.pop("orders", KNOWN_ORDERS)
        with pytest.raises(ValueError):
            auto.auto_fit(torch.as_tensor(panel), orders, device="cpu",
                          **kw)
    # shard=/mesh= ride to every walk of the search: four lanes select and
    # fit what the single-lane search on the same chunk grid does, bit
    # for bit, and the selection is the reference's sharded search's
    mesh = meshlib.default_mesh(devices=[torch.device("cpu")] * 4)
    rows = -(-panel.shape[0] // 4)
    one = _port(panel, KNOWN_ORDERS, fuse=1, chunk_rows=rows)
    four = _port(panel, KNOWN_ORDERS, fuse=1, mesh=mesh)
    for f in ("order_index", "params", "neg_log_likelihood", "status"):
        np.testing.assert_array_equal(np.asarray(getattr(four, f)),
                                      np.asarray(getattr(one, f)))
    ref = _ref(panel, KNOWN_ORDERS, fuse=1, shard=True)
    np.testing.assert_array_equal(np.asarray(four.order_index),
                                  np.asarray(ref.order_index))

"""The port's delta walks (``reliability.delta`` through
``fit_chunked(delta_from=)``) against the reference's.

Bit for bit against the reference: ``plan_delta``'s chunk classes
(adopted, warm, dirty, new), its counts and its warm-start matrix, on
prior journals each package wrote of the same panel with a stand-in fit
of exact float32 arithmetic, for the same new panels (unchanged, a
revised block, appended series, appended time steps); the port's planner
on the reference's journal classifies alike (the chunk fingerprints are
the same bytes).  ``WarmstartFit`` against the reference's on the same
augmented panel within the ARIMA parity bar (4e-3).  The port's own
promises, bit for bit: a delta walk with ``delta_warmstart=False`` equals
the cold walk of the new panel and fits only its dirty and new chunks; a
delta of an unchanged panel launches no fit at all; a crashed delta walk
resumes without refitting an adopted chunk.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_timeseries_tpu import reliability as jrel
from spark_timeseries_tpu.models import arima as jarima
from spark_timeseries_tpu.models import base as jbase
from spark_timeseries_tpu.reliability import delta as jdelta
from spark_timeseries_tpu_torch import reliability as rel
from spark_timeseries_tpu_torch.models import arima
from spark_timeseries_tpu_torch.models import base as tbase
from spark_timeseries_tpu_torch.reliability import delta as tdelta
from spark_timeseries_tpu_torch.reliability import faultinject as fi

FIELDS = ("params", "neg_log_likelihood", "converged", "iters", "status")
B, T, CHUNK = 48, 64, 12
PARAM_TOL = 4e-3


def _tfake(y, *, align_mode=None, init_params=None, device="cpu"):
    return tbase.FitResult(torch.stack([y[:, 0], y[:, -1]], 1) * 2.0,
                           y[:, 1] + y[:, 2], y[:, 0] > 0,
                           (y[:, 3] > 0).to(torch.int32), None)


def _jfake(y, *, align_mode=None, init_params=None):
    y = jnp.asarray(y)
    return jbase.FitResult(jnp.stack([y[:, 0], y[:, -1]], 1) * 2.0,
                           y[:, 1] + y[:, 2], y[:, 0] > 0,
                           (y[:, 3] > 0).astype(jnp.int32), None)


def _panel(b=B, t=T, seed=21):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, t)).astype(np.float32)
    y = np.zeros_like(e)
    y[:, 0] = e[:, 0]
    for i in range(1, t):
        y[:, i] = 0.5 * y[:, i - 1] + e[:, i]
    return y


def _assert_bitwise(a, b):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"field {f!r} differs")


def _new_panels(y):
    """name -> the new panel a delta walk diffs against ``y``'s journal."""
    rng = np.random.default_rng(5)
    revised = y.copy()
    revised[14:16] += 1.0  # inside the second chunk, on sampled rows
    grown_rows = np.concatenate([y, _panel(7, T, seed=3)])
    grown_time = np.concatenate(
        [y, rng.normal(size=(B, 4)).astype(np.float32)], axis=1)
    return {"same": y, "revised": revised, "rows": grown_rows,
            "time": grown_time}


@pytest.fixture(scope="module")
def priors(tmp_path_factory):
    """Prior journals of the same panel: (port root, reference root)."""
    y = _panel()
    d = tmp_path_factory.mktemp("priors")
    pr, rr = str(d / "port"), str(d / "ref")
    rel.fit_chunked(_tfake, torch.as_tensor(y), chunk_rows=CHUNK,
                    resilient=False, device="cpu", checkpoint_dir=pr)
    jrel.fit_chunked(_jfake, y, chunk_rows=CHUNK, resilient=False,
                     checkpoint_dir=rr)
    return y, pr, rr


def _classes(plan):
    return [tuple(c) for c in plan.chunks], dict(plan.counts)


@pytest.mark.parametrize("name", ["same", "revised", "rows", "time"])
@pytest.mark.parametrize("warmstart", [True, False])
def test_plan_delta_classes_are_the_references(priors, name, warmstart):
    y, pr, rr = priors
    new = _new_panels(y)[name]
    got = tdelta.plan_delta(pr, torch.as_tensor(new), warmstart=warmstart)
    want = jdelta.plan_delta(rr, jnp.asarray(new), warmstart=warmstart)
    assert _classes(got) == _classes(want)
    assert (got.grown, got.data_cols, got.chunk_rows, got.k) == \
        (want.grown, want.data_cols, want.chunk_rows, want.k)
    if want.init is None:
        assert got.init is None
    else:
        np.testing.assert_array_equal(got.init, want.init)
    # the port's planner reads the reference's journal alike, and a host
    # source plans like the tensor
    cross = tdelta.plan_delta(rr, rel.HostChunkSource(new),
                              warmstart=warmstart)
    assert _classes(cross) == _classes(want)
    if name == "same":
        assert got.counts == {"adopted": 4, "warm": 0, "dirty": 0, "new": 0}
    if name == "revised":
        assert [c.cls for c in got.chunks] == ["adopted", "dirty",
                                               "adopted", "adopted"]


def test_stale_priors_are_refused(priors, tmp_path):
    y, pr, _ = priors
    with pytest.raises(tdelta.StalePriorError, match="shrunk|disappeared"):
        tdelta.plan_delta(pr, torch.as_tensor(y[:20]))
    with pytest.raises(tdelta.StalePriorError, match="time axis shrank"):
        tdelta.plan_delta(pr, torch.as_tensor(y[:, :30]))
    with pytest.raises(tdelta.StalePriorError, match="grid"):
        tdelta.plan_delta(pr, torch.as_tensor(y), chunk_rows=8)
    with pytest.raises(tdelta.DeltaError, match="no manifest"):
        tdelta.plan_delta(str(tmp_path), torch.as_tensor(y))
    # a version-1 manifest (no chunk fingerprints): resumable, not a prior
    old = str(tmp_path / "v1")
    os.makedirs(old)
    with open(os.path.join(pr, "manifest.json")) as f:
        m = json.load(f)
    for c in m["chunks"]:
        c.pop("chunk_fingerprint")
    with open(os.path.join(old, "manifest.json"), "w") as f:
        json.dump(m, f)
    with pytest.raises(tdelta.StalePriorError, match="chunk_fingerprint"):
        tdelta.plan_delta(old, torch.as_tensor(y))
    # a prior fitted under another config adopts nothing
    with pytest.raises(tdelta.StalePriorError, match="different config"):
        rel.fit_chunked(functools.partial(_tfake), torch.as_tensor(y),
                        chunk_rows=CHUNK, resilient=False, device="cpu",
                        checkpoint_dir=str(tmp_path / "n"), delta_from=pr)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        rel.fit_chunked(_tfake, torch.as_tensor(y), resilient=False,
                        device="cpu", delta_from=pr)


def test_reference_journals_are_never_adopted(priors, tmp_path):
    # the recorded difference: the config hash names the fit's module
    y, _, rr = priors
    with pytest.raises(tdelta.StalePriorError, match="different config"):
        rel.fit_chunked(_tfake, torch.as_tensor(y), chunk_rows=CHUNK,
                        resilient=False, device="cpu",
                        checkpoint_dir=str(tmp_path / "n"), delta_from=rr)


# -- delta walks of an ARIMA fit ------------------------------------------------


def _counting(calls):
    @functools.wraps(arima.fit)
    def fit(y, *a, **kw):
        calls.append(int(y.shape[0]))
        return arima.fit(y, *a, **kw)

    return fit


def _walk(fit, y, **kw):
    return rel.fit_chunked(fit, torch.as_tensor(y), chunk_rows=CHUNK,
                           order=(1, 0, 0), max_iters=25, device="cpu", **kw)


@pytest.fixture(scope="module")
def arima_prior(tmp_path_factory):
    y = _panel()
    root = str(tmp_path_factory.mktemp("arima") / "prior")
    calls = []
    res = _walk(_counting(calls), y, checkpoint_dir=root)
    return y, root, res, calls


def test_exact_delta_equals_the_cold_walk(arima_prior, tmp_path):
    y, root, _, calls = arima_prior
    new = _new_panels(y)["revised"]
    calls.clear()
    res = _walk(_counting(calls), new, checkpoint_dir=str(tmp_path / "d"),
                delta_from=root, delta_warmstart=False)
    assert calls == [CHUNK]  # the one dirty chunk
    assert res.meta["delta"]["counts"] == {"adopted": 3, "warm": 0,
                                           "dirty": 1, "new": 0}
    cold = _walk(_counting([]), new)
    _assert_bitwise(res, cold)
    with open(os.path.join(str(tmp_path / "d"), "manifest.json")) as f:
        m = json.load(f)
    classes = [(c.get("delta") or {}).get("class") for c in m["chunks"]]
    assert classes == ["adopted", None, "adopted", "adopted"]
    assert m["extra"]["delta"]["counts"] == res.meta["delta"]["counts"]


def test_delta_of_an_unchanged_panel_fits_nothing(arima_prior, tmp_path):
    y, root, prior, calls = arima_prior
    calls.clear()
    res = _walk(_counting(calls), y, checkpoint_dir=str(tmp_path / "d"),
                delta_from=root, delta_warmstart=False)
    assert calls == []
    _assert_bitwise(res, prior)
    assert res.meta["journal"]["chunks_resumed"] == B // CHUNK


def test_appended_series_refit_only_the_new_rows(arima_prior, tmp_path):
    y, root, _, calls = arima_prior
    new = _new_panels(y)["rows"]
    calls.clear()
    res = _walk(_counting(calls), new, checkpoint_dir=str(tmp_path / "d"),
                delta_from=root, delta_warmstart=False)
    assert calls == [7]
    _assert_bitwise(res, _walk(_counting([]), new))


def test_crashed_delta_walk_resumes_without_refitting(arima_prior, tmp_path):
    y, root, _, calls = arima_prior
    new = _new_panels(y)["revised"]
    d = str(tmp_path / "d")
    with pytest.raises(fi.SimulatedCrash):
        _walk(_counting([]), new, checkpoint_dir=d, delta_from=root,
              delta_warmstart=False,
              _journal_commit_hook=fi.crash_after_commits(1))
    calls.clear()
    res = _walk(_counting(calls), new, checkpoint_dir=d, delta_from=root,
                delta_warmstart=False)
    assert calls == [CHUNK]  # adoption survived the crash
    _assert_bitwise(res, _walk(_counting([]), new))


def test_warm_delta_runs_and_refuses_the_resilient_path(arima_prior,
                                                        tmp_path):
    y, root, prior, calls = arima_prior
    new = _new_panels(y)["time"]
    with pytest.raises(ValueError, match="resilient=False"):
        _walk(arima.fit, new, checkpoint_dir=str(tmp_path / "r"),
              delta_from=root)
    res = _walk(arima.fit, new, resilient=False,
                checkpoint_dir=str(tmp_path / "w"), delta_from=root)
    assert res.meta["delta"]["counts"]["warm"] == B // CHUNK
    assert res.meta["delta"]["warmstart"] is True
    assert res.params.shape == prior.params.shape
    ok = res.status == rel.FitStatus.OK
    assert ok.mean() > 0.9


def test_warmstart_fit_matches_reference():
    y = _panel(96, T, seed=8)
    init = np.full((96, 2), np.nan, np.float32)
    init[:64] = [[0.0, 0.5]]
    aug = np.concatenate([y, init], axis=1)
    kw = dict(order=(1, 0, 0), max_iters=40)
    port = tdelta.WarmstartFit(arima.fit, T, 2)(
        torch.as_tensor(aug), device="cpu", **kw)
    ref = jdelta.WarmstartFit(jarima.fit, T, 2)(jnp.asarray(aug), **kw)
    np.testing.assert_array_equal(port.converged.numpy(),
                                  np.asarray(ref.converged))
    fin = port.converged.numpy()
    np.testing.assert_allclose(port.params.numpy()[fin],
                               np.asarray(ref.params)[fin],
                               rtol=PARAM_TOL, atol=PARAM_TOL)
    assert repr(tdelta.WarmstartFit(arima.fit, T, 2)).startswith(
        "WarmstartFit(spark_timeseries_tpu_torch.models.arima.fit")

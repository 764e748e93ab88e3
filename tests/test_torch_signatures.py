"""The port's public signatures against the reference's.

Every public function of a ported module that the reference module also
defines takes the same keyword set, except for the differences recorded
under ``ROADMAP.md`` queue 3, "Deliberate differences", which are listed
here with their reasons.  A call written for the reference then never
meets a ``TypeError`` on the port for a keyword the port forgot.
"""

import importlib
import inspect

import pytest

# module paths the port mirrors (under spark_timeseries_tpu_torch and
# spark_timeseries_tpu), with the kernels module that replaces the
# reference's Pallas one
MODULES = {
    "models.arima": "models.arima",
    "models.autoregression": "models.autoregression",
    "models.regression_arima": "models.regression_arima",
    "models.base": "models.base",
    "models.ewma": "models.ewma",
    "models.garch": "models.garch",
    "models.holtwinters": "models.holtwinters",
    "utils.optim": "utils.optim",
    "utils.linalg": "utils.linalg",
    "ops.layout": "ops.layout",
    "ops.univariate": "ops.univariate",
    "ops.lagmat": "ops.lagmat",
    "ops.cuda_kernels": "ops.pallas_kernels",
    "reliability.status": "reliability.status",
    "reliability.sanitize": "reliability.sanitize",
    "reliability.watchdog": "reliability.watchdog",
    "reliability.runner": "reliability.runner",
    "reliability.faultinject": "reliability.faultinject",
    "reliability.plan": "reliability.plan",
    "reliability.journal": "reliability.journal",
    "reliability.committer": "reliability.committer",
    "reliability.source": "reliability.source",
    "reliability.prefetcher": "reliability.prefetcher",
    "reliability.sink": "reliability.sink",
    "reliability.delta": "reliability.delta",
    "reliability.chunked": "reliability.chunked",
    "forecasting.augment": "forecasting.augment",
    "stats.tests": "stats.tests",
    "index": "index",
    "obs.core": "obs.core",
    "obs.memory": "obs.memory",
    "obs.promsink": "obs.promsink",
    "obs.tracing": "obs.tracing",
    "utils.compile_cache": "utils.compile_cache",
}

_DEVICE = ({"device"}, set())
_INTERPRET = (set(), {"interpret"})
# (port module, name) -> (keywords only the port takes, keywords only the
# reference takes), each a recorded difference
ALLOWED = {
    # every entry point takes device= (default "cuda")
    **{("models.arima", n): _DEVICE
       for n in ("fit", "forecast", "fit_grid", "add_time_dependent_effects",
                 "remove_time_dependent_effects")},
    **{("models.autoregression", n): _DEVICE
       for n in ("fit", "forecast", "add_time_dependent_effects",
                 "remove_time_dependent_effects")},
    **{("models.regression_arima", n): _DEVICE
       for n in ("fit_cochrane_orcutt", "predict")},
    **{("stats.tests", n): _DEVICE
       for n in ("adftest", "dwtest", "bgtest", "bptest", "lbtest",
                 "kpsstest", "batch_adftest", "batch_dwtest", "batch_lbtest",
                 "batch_kpsstest", "batch_bgtest", "batch_bptest")},
    **{("models.ewma", n): _DEVICE
       for n in ("fit", "add_time_dependent_effects",
                 "remove_time_dependent_effects")},
    **{("models.garch", n): _DEVICE
       for n in ("fit", "fit_argarch", "add_time_dependent_effects",
                 "remove_time_dependent_effects")},
    **{("models.holtwinters", n): _DEVICE
       for n in ("fit", "forecast", "fitted")},
    # forecasts that run a kernel take the fit's backend choice
    ("models.ewma", "forecast"): ({"backend", "device"}, set()),
    ("models.garch", "forecast"): ({"backend", "device"}, set()),
    # a torch.Generator or an integer seed in place of a JAX key
    ("models.garch", "sample"): ({"device", "gen"}, {"key"}),
    ("models.garch", "argarch_sample"): ({"device", "gen"}, {"key"}),
    ("models.arima", "sample"): ({"device", "gen"}, {"key"}),
    ("models.autoregression", "sample"): ({"device", "gen"}, {"key"}),
    # the backend resolves on the panel itself, with the port's names
    ("models.base", "resolve_backend"): ({"y"}, {"dtype", "n_time"}),
    ("ops.cuda_kernels", "supported"): ({"x"}, {"dtype", "n_time"}),
    # no interpret mode: a kernel runs on the card, its plain version on
    # the CPU; the folded panels are the time-major [T, B] layout
    **{("ops.cuda_kernels", n): _INTERPRET
       for n in ("css_errors", "css_last_errors", "css_neg_loglik",
                 "fill_linear_chain", "fill_linear",
                 "fill_linear_chain_folded", "batch_autocorr",
                 "batch_autocorr_folded", "garch_variances",
                 "garch_neg_loglik", "ewma_smooth", "ewma_sse",
                 "hw_sse_seeded", "hw_sse")},
    ("ops.cuda_kernels", "css_neg_loglik_folded"): (
        {"yt", "zb"}, {"interpret", "y3", "zb3"}),
    ("ops.cuda_kernels", "hr_init"): ({"yt"}, {"interpret", "y3"}),
}


def _shared_functions():
    """``(port module, name, port function, reference function)`` for every
    public function of a ported module that the reference module defines
    too."""
    out = []
    for pmod, rmod in MODULES.items():
        port = importlib.import_module(f"spark_timeseries_tpu_torch.{pmod}")
        ref = importlib.import_module(f"spark_timeseries_tpu.{rmod}")
        for name, fn in sorted(vars(port).items()):
            if (name.startswith("_") or not inspect.isfunction(fn)
                    or fn.__module__ != port.__name__):
                continue
            rfn = getattr(ref, name, None)
            if callable(rfn):
                out.append((pmod, name, fn, rfn))
    return out


def _keywords(fn) -> set:
    return set(inspect.signature(fn).parameters)


# collected from the modules' names, which do not depend on the host
_CASES = [(m, n) for m, n, _, _ in _shared_functions()]


@pytest.mark.parametrize("module,name", _CASES,
                         ids=[f"{m}.{n}" for m, n in _CASES])
def test_keywords_match_the_reference(module, name):
    port = importlib.import_module(f"spark_timeseries_tpu_torch.{module}")
    ref = importlib.import_module(f"spark_timeseries_tpu.{MODULES[module]}")
    got, want = _keywords(getattr(port, name)), _keywords(getattr(ref, name))
    only_port, only_ref = ALLOWED.get((module, name), (set(), set()))
    assert (got - want, want - got) == (only_port, only_ref)


def test_every_allowed_difference_is_still_a_shared_function():
    # a stale entry (the function renamed or gone) would hide nothing,
    # but it would record a difference that no longer exists
    assert set(ALLOWED) <= set(_CASES)


@pytest.mark.parametrize("module,name", [
    ("models.arima", "fit"), ("models.garch", "fit"),
    ("models.holtwinters", "fit"), ("utils.optim", "minimize_lbfgs_batched"),
    ("models.base", "debatch_fit"),
    ("models.base", "require_pallas_for_count_evals")])
def test_pass_accounting_names_exist(module, name):
    # the reference's pass-accounting surface, present in the port
    assert (module, name) in _CASES

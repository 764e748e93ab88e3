"""The port's public names and signatures against the reference's.

Every public name of a ported module (and of a ported package's
``__init__``) exists in the port, and every public function and class the
reference module defines takes the same keyword set in the port —
constructors and public methods included — except for the differences
recorded under ``ROADMAP.md`` queue 3, "Deliberate differences", which
are listed here with their reasons.  A call written for the
reference then never meets an ``AttributeError`` or a ``TypeError`` on the
port for a name or keyword the port forgot.
"""

import ast
import importlib
import inspect
import pathlib

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
    "forecasting.kernels": "forecasting.kernels",
    "forecasting.params": "forecasting.params",
    "forecasting.walk": "forecasting.walk",
    "forecasting.ensemble": "forecasting.ensemble",
    "forecasting.backtest": "forecasting.backtest",
    "models.auto": "models.auto",
    "stats.tests": "stats.tests",
    "index": "index",
    "obs.core": "obs.core",
    "obs.memory": "obs.memory",
    "obs.promsink": "obs.promsink",
    "obs.tracing": "obs.tracing",
    "utils.compile_cache": "utils.compile_cache",
    "parallel.mesh": "parallel.mesh",
    "ops.seqparallel": "ops.seqparallel",
    "panel": "panel",
    "compat.sparkts": "compat.sparkts",
    "plot": "plot",
    "serving.session": "serving.session",
    "serving.admission": "serving.admission",
    "serving.batcher": "serving.batcher",
    "serving.profiles": "serving.profiles",
    "serving.server": "serving.server",
    "serving.tickloop": "serving.tickloop",
    "serving.health": "serving.health",
    "serving.transport": "serving.transport",
    "serving.client": "serving.client",
    "serving.fleet": "serving.fleet",
    "reliability.chaos": "reliability.chaos",
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
    ("ops.cuda_kernels", "hw_additive_sse"): _INTERPRET,
    # the forecast walk, ensembles and backtests place a host panel on
    # device= (default "cuda"); a chunk fit function receives it too
    **{("forecasting.walk", n): _DEVICE
       for n in ("forecast_chunked", "forecast_fit", "warmstart_fit")},
    ("forecasting.ensemble", "ensemble_forecast"): _DEVICE,
    ("forecasting.backtest", "run_backtest"): _DEVICE,
    # the panel, compat and plot entry points that turn host data into
    # tensors place it on device= (default "cuda"); a tensor stays put
    **{("panel", n): _DEVICE
       for n in ("from_observations", "from_dataframe", "from_series_dict")},
    **{("compat.sparkts", n): _DEVICE
       for n in ("load_model", "time_series_rdd_from_observations",
                 "time_series_rdd_from_pandas_dataframe",
                 "time_series_rdd_from_parquet")},
    **{("plot", n): _DEVICE for n in ("acf_plot", "pacf_plot")},
    # a process group's devices are torch devices of any kind (a CPU
    # device listed several times is how the gloo group runs on a CPU)
    ("parallel.mesh", "init_distributed"): ({"devices"}, set()),
}

# (port module, name) -> why the reference's public name is absent
ABSENT = {
    ("models.base", "jit_program"):
        "the port compiles no programs (deliberate difference)",
    **{("utils.optim", n): "the lazy stage-1/stage-2 split is one loop in "
       "the port (deliberate difference)"
       for n in ("StragglerCarry", "lbfgs_batched_stage1",
                 "lbfgs_batched_stage2")},
}
# (port module, class, method) -> why a public method is absent
ABSENT_METHODS = {
    ("ops.layout", "FoldedPanel", "tree_flatten"):
        "FoldedPanel is no JAX pytree (deliberate difference)",
}
# (port module, class) -> (constructor keywords only the port takes,
# those only the reference takes)
ALLOWED_CTORS = {
    ("reliability.source", "DeviceChunkSource"): _DEVICE,
    ("reliability.prefetcher", "ChunkPrefetcher"): _DEVICE,
    # host values / parameters go to device=; a mesh-attached panel's
    # values sit on the mesh's first device (the mesh lists torch devices)
    ("panel", "TimeSeriesPanel"): _DEVICE,
    **{("compat.sparkts", n): _DEVICE
       for n in ("ARIMAModel", "SeasonalARIMAModel", "ARModel", "EWMAModel",
                 "GARCHModel", "ARGARCHModel", "HoltWintersModel",
                 "RegressionARIMAModel")},
    # the server and the tick loop fit on device= (default "cuda")
    ("serving.server", "FitServer"): _DEVICE,
    ("serving.tickloop", "TickLoop"): _DEVICE,
}
# package __init__ (relative name) -> names the reference exports that the
# port's does not (none: the port exports every one)
ABSENT_EXPORTS = {}
# package __init__s the port has
PACKAGES = ("", "compat", "forecasting", "models", "obs", "ops", "parallel",
            "reliability", "serving", "stats", "utils")


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


def _modules(pmod):
    return (importlib.import_module(f"spark_timeseries_tpu_torch.{pmod}"),
            importlib.import_module(
                f"spark_timeseries_tpu.{MODULES[pmod]}"))


def _public_names(mod) -> set:
    """A module's public names: its ``__all__`` and every public function
    and class it defines."""
    names = set(getattr(mod, "__all__", ()) or ())
    for name, v in vars(mod).items():
        if (not name.startswith("_")
                and (inspect.isfunction(v) or inspect.isclass(v))
                and getattr(v, "__module__", None) == mod.__name__):
            names.add(name)
    return names


_NAME_CASES = [(m, n) for m in MODULES
               for n in sorted(_public_names(_modules(m)[1]))]


@pytest.mark.parametrize("module,name", _NAME_CASES,
                         ids=[f"{m}.{n}" for m, n in _NAME_CASES])
def test_reference_name_exists_in_port(module, name):
    port, _ = _modules(module)
    if (module, name) in ABSENT:
        assert not hasattr(port, name), "ported: drop the ABSENT entry"
    else:
        assert hasattr(port, name)


def _signature_keywords(obj):
    try:
        return set(inspect.signature(obj).parameters)
    except (TypeError, ValueError):  # an exception class's builtin init
        return None


def _shared_classes():
    out = []
    for pmod in MODULES:
        port, ref = _modules(pmod)
        for name in sorted(_public_names(ref)):
            rc, pc = getattr(ref, name), getattr(port, name, None)
            if inspect.isclass(rc) and inspect.isclass(pc):
                out.append((pmod, name))
    return out


_CLASS_CASES = _shared_classes()


@pytest.mark.parametrize("module,name", _CLASS_CASES,
                         ids=[f"{m}.{n}" for m, n in _CLASS_CASES])
def test_class_constructor_and_methods_match_the_reference(module, name):
    port, ref = _modules(module)
    pc, rc = getattr(port, name), getattr(ref, name)
    got, want = _signature_keywords(pc), _signature_keywords(rc)
    if got is not None and want is not None:
        only_port, only_ref = ALLOWED_CTORS.get((module, name),
                                                (set(), set()))
        assert (got - want, want - got) == (only_port, only_ref)
    for mname, rm in vars(rc).items():
        if mname.startswith("_") or not inspect.isfunction(rm):
            continue
        pm = getattr(pc, mname, None)
        if (module, name, mname) in ABSENT_METHODS:
            assert pm is None, "ported: drop the ABSENT_METHODS entry"
            continue
        assert pm is not None, f"{name}.{mname} missing"
        assert _signature_keywords(pm) == _signature_keywords(rm), mname


def _package_exports(pkg: str, root: str) -> set:
    """Names a package ``__init__`` exports: its ``__all__``, else every
    public name its source binds at module level (read from the source,
    so submodules other imports attached to the package do not count)."""
    mod = importlib.import_module(root + (f".{pkg}" if pkg else ""))
    if getattr(mod, "__all__", None):
        return set(mod.__all__)
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("pkg", PACKAGES, ids=[p or "top" for p in PACKAGES])
def test_package_exports_the_reference_names(pkg):
    want = _package_exports(pkg, "spark_timeseries_tpu")
    port = importlib.import_module(
        "spark_timeseries_tpu_torch" + (f".{pkg}" if pkg else ""))
    absent = ABSENT_EXPORTS.get(pkg, {})
    missing = {n for n in want if not hasattr(port, n)}
    assert missing == set(absent)
    assert set(absent) <= want  # no stale entry


def test_every_absent_entry_is_a_reference_name():
    cases = set(_NAME_CASES)
    assert set(ABSENT) <= cases
    assert set(ALLOWED_CTORS) <= set(_CLASS_CASES)
    assert {(m, c) for m, c, _ in ABSENT_METHODS} <= set(_CLASS_CASES)

"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package nor anything under the repository's ``tools/``, at run time or in
its source."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "spark_timeseries_tpu_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import spark_timeseries_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "spark_timeseries_tpu"
             or m.startswith("spark_timeseries_tpu."))
import os
tools = os.path.join(os.path.dirname(os.path.dirname(port.__file__)),
                     "tools") + os.sep
# a module loaded from tools/ (by name or by file path), or tools/ put on
# the import path, is the port leaning on the reference's side
bad += sorted(m for m, mod in list(sys.modules.items())
              if (getattr(mod, "__file__", None) or "").startswith(tools))
bad += [p for p in sys.path if p.rstrip(os.sep) + os.sep == tools]
print(len(names), bad)
assert not bad, bad
for name in ("models.auto", "forecasting._prng", "forecasting.kernels",
             "forecasting.params", "forecasting.walk",
             "forecasting.ensemble", "forecasting.backtest", "panel", "plot",
             "compat.sparkts", "parallel.mesh", "ops.seqparallel",
             "serving.session", "serving.admission", "serving.batcher",
             "serving.profiles", "serving.server", "serving.tickloop",
             "serving._advise"):
    assert port.__name__ + "." + name in names, name
from spark_timeseries_tpu_torch.serving import FitServer
srv = FitServer(os.environ["STS_ISOLATION_ROOT"], device="cpu")
assert srv._advise is not None  # the package's own advisor copy
bad = sorted(m for m, mod in list(sys.modules.items())
             if (getattr(mod, "__file__", None) or "").startswith(tools))
assert not bad, bad
"""


def test_import_loads_no_jax_and_no_reference_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               STS_ISOLATION_ROOT=str(tmp_path / "srv"))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 62  # every submodule was imported


# the card's machine has no pandas, pyarrow or matplotlib: the port must
# import without them (the functions that need them import them inside)
_PROBE_NO_EXTRAS = r"""
import importlib, pkgutil, sys


class _Absent:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("pandas", "pyarrow", "matplotlib"):
            raise ImportError(f"{name} is absent")


sys.meta_path.insert(0, _Absent())
import spark_timeseries_tpu_torch as port
for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(m.name)
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("pandas", "pyarrow", "matplotlib")))
"""


def test_import_needs_no_pandas_pyarrow_or_matplotlib():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE_NO_EXTRAS], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"import\s+spark_timeseries_tpu(?!_torch)\b|"
    r"from\s+spark_timeseries_tpu(?!_torch)\b)", re.M)
# loading a tools/ script: by module name, or by file path next to the
# package (the reference server loads tools/advise_budget.py that way)
_TOOLS = re.compile(
    r"^\s*(import\s+(tools|advise_budget|inspect_journal|obs_report)\b|"
    r"from\s+(tools|advise_budget|inspect_journal|obs_report)\b)|"
    r"spec_from_file_location|[\"']tools[\"']\s*\)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path
    assert not _TOOLS.search(text), path


def test_chip_smoke_has_no_jax_import():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not _FORBIDDEN.search(text)

"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, at run time or in its source."""

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
print(len(names), bad)
assert not bad, bad
"""


def test_import_loads_no_jax_and_no_reference_module():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 38  # every submodule was imported


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b|"
    r"import\s+spark_timeseries_tpu(?!_torch)\b|"
    r"from\s+spark_timeseries_tpu(?!_torch)\b)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")))
def test_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), path


def test_chip_smoke_has_no_jax_import():
    text = (ROOT / "chip_smoke.py").read_text()
    assert not _FORBIDDEN.search(text)

"""Nothing under bench_port/ imports JAX or the JAX package (top-level
names compared whole), and the references import nothing of the
program."""

import ast
from pathlib import Path

import pytest

from benchlib import runner

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "spark_timeseries_tpu"}
PROGRAM = "spark_timeseries_tpu_torch"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not (_imports(path) & FORBIDDEN)


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_independent(path):
    assert PROGRAM not in _imports(path)
    assert PROGRAM not in path.read_text()


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "spark_timeseries_tpu_torch.fake", sys)
    assert "spark_timeseries_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "spark_timeseries_tpu.models", sys)
    assert "spark_timeseries_tpu" in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert "jaxlib" in runner.forbidden_modules()

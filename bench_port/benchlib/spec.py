"""Find a cell's files by the names in ``BENCHMARK.json``.

- ``configs/<config>.json``: the configuration, with its generator
  ``gen/<config>.py`` (``make(cfg, seed, device, index)``, ``index`` the
  panel's place in the run) and its plain reference
  ``reference/<cfg["reference"]>.py``;
- ``traffic/<traffic>.json``: the traffic mix, read by ``benchlib.drive``
  (keys: ``MIX_KEYS``).  Its ``judge`` and ``control`` name a function of
  the configuration's reference, or ``<module>.<function>`` of any file
  under ``reference/``, so a cell with a new kind of answer brings its
  judge in a new file;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: one reader for each metric
  (``read(run) -> float | None``).  A quantity split by the cells whose
  end-to-end metric it moves is named ``<metric>.<part>``, and is read by
  ``metrics/<metric>.py`` unless it has a file of its own.
"""

import hashlib
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
CHECKOUT = BENCH.parent
# what a traffic mix may say; any other key is refused, not ignored
MIX_KEYS = frozenset({"what", "panels", "stages", "keep", "judge",
                      "control"})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def panel_seed(seed: int, k: int) -> int:
    """The seed of panel ``k`` of a run with ``seed``: 63 bits of a hash,
    so any whole number gives a valid generator seed."""
    h = hashlib.sha256(f"{int(seed)}:{int(k)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def metric_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or that of the quantity it splits
    (``series_per_s.vol`` -> ``series_per_s``)."""
    name = metric
    while True:
        path = BENCH / "metrics" / f"{name}.py"
        if path.is_file() or "." not in name:
            return path
        name = name.rpartition(".")[0]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: dict = None):
        bench = benchmark() if bench is None else bench
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        self.chips = int(self.workload["chips"])
        cfg_name = self.workload["config"]
        self.config = load_json(BENCH / "configs" / f"{cfg_name}.json")
        self.traffic = load_json(
            BENCH / "traffic" / f"{self.workload['traffic']}.json")
        unknown = set(self.traffic) - MIX_KEYS
        if unknown:
            raise ValueError(f"traffic {self.workload['traffic']!r}: keys "
                             f"{sorted(unknown)} are not run")
        self.generator = load_module(BENCH / "gen" / f"{cfg_name}.py",
                                     f"bench_gen_{cfg_name}")
        self.reference = importlib.import_module(
            f"reference.{self.config['reference']}")
        limits = BENCH / "limits" / f"{name}.json"
        self.limits = load_json(limits)["limits"] if limits.is_file() \
            else {}
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]

    def reference_fn(self, key: str):
        """The mix's ``judge`` or ``control`` function: ``<function>`` of
        the configuration's reference, or ``<module>.<function>`` of
        ``reference/<module>.py``."""
        module, _, fn = self.traffic[key].rpartition(".")
        mod = importlib.import_module(f"reference.{module}") if module \
            else self.reference
        return getattr(mod, fn)

    def metric_reader(self, metric: str):
        path = metric_path(metric)
        return load_module(path, "bench_metric_" +
                           path.stem.replace(".", "_"))

    def make_panels(self, seed: int, device) -> list:
        return [self.generator.make(self.config, panel_seed(seed, k), device,
                                    k)
                for k in range(int(self.traffic["panels"]))]

"""BENCHMARK.json resolves, entry by entry, to the files under bench_port/
and keeps to its rules on names, units and bounds."""

import json
import re

import pytest

from benchlib import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench_port"]
    assert BENCH["command"] == ["python3", "bench_port/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((spec.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    assert NAME.match(cfg["name"])
    path = spec.CHECKOUT / cfg["file"]
    assert path == spec.BENCH / "configs" / f"{cfg['name']}.json"
    body = json.loads(path.read_text())
    assert body["name"] == cfg["name"]
    assert body["reduced"] == cfg["reduced"] == []
    assert len(body["source"]) <= 200
    assert (spec.BENCH / "gen" / f"{cfg['name']}.py").is_file()
    assert (spec.BENCH / "reference" / f"{body['reference']}.py").is_file()
    assert body["source"] == cfg["source"]
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_resolves(name):
    cell = spec.Cell(name)
    w = cell.workload
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200
    assert hasattr(cell.generator, "make")
    assert callable(cell.reference_fn("judge"))
    assert callable(cell.reference_fn("control"))
    assert set(cell.traffic) <= spec.MIX_KEYS
    for st in cell.traffic["stages"]:
        if "entry" in st:
            assert st["entry"] in cell.config["entries"]
    assert cell.limits, "every cell has its limits file"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:  # each moves a metric that this cell reports
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    path = spec.metric_path(metric["name"])
    assert path.is_file()
    assert path.stem == metric["name"] or \
        metric["name"].startswith(path.stem + ".")
    mod = spec.load_module(path, "t_" + metric["name"].replace(".", "_"))
    assert callable(mod.read)
    for w in metric.get("workloads", []):
        assert w in WORKLOADS
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")


def test_names_unique():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_split_metric_reads_as_its_quantity():
    assert spec.metric_path("series_per_s.vol") == \
        spec.BENCH / "metrics" / "series_per_s.py"
    assert spec.metric_path("transforms_ms.vol").name == "transforms_ms.vol.py"


def test_panel_seed_spans_large_seeds():
    a = spec.panel_seed(2 ** 31 + 11, 0)
    assert a == spec.panel_seed(2 ** 31 + 11, 0)
    assert a != spec.panel_seed(2 ** 31 + 11, 1)
    assert 0 <= a < 2 ** 63


def _stub_tree(tmp_path, mix: dict):
    """A copy of the benchmark's configuration and generator of ARIMA
    beside a new traffic file: what a later cell adds."""
    import shutil
    for sub in ("configs", "gen", "traffic", "reference"):
        (tmp_path / sub).mkdir()
    for sub, ext in (("configs", "json"), ("gen", "py")):
        shutil.copy(spec.BENCH / sub / f"arima111_daily_1m.{ext}",
                    tmp_path / sub)
    (tmp_path / "traffic" / "stub.json").write_text(json.dumps(mix))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "arima111_daily_1m.stub",
                               "config": "arima111_daily_1m",
                               "traffic": "stub", "chips": 1, "why": "x"})
    return bench


def test_judge_in_a_new_reference_file(tmp_path, monkeypatch):
    """A cell with a new kind of answer on a configuration that exists
    brings its judge and control in a new file under reference/, and no
    file that exists changes."""
    import reference
    bench = _stub_tree(tmp_path, {
        "what": "x", "panels": 1, "keep": ["rows"],
        "stages": [{"out": "rows", "call": "torch.numel",
                    "args": ["@panel"]}],
        "judge": "stub_answers.judge_rows",
        "control": "stub_answers.control_rows"})
    (tmp_path / "reference" / "stub_answers.py").write_text(
        "def judge_rows(cfg, panel, outputs):\n"
        "    return {'rows_gap': abs(outputs['rows'] - panel.numel())}\n"
        "\n"
        "def control_rows(cfg, panel, dtype):\n"
        "    return {'rows': panel.numel() + 1}\n")
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    monkeypatch.setattr(reference, "__path__",
                        list(reference.__path__) + [str(tmp_path /
                                                        "reference")])
    cell = spec.Cell("arima111_daily_1m.stub", bench)
    judge, control = cell.reference_fn("judge"), cell.reference_fn("control")
    assert judge.__module__ == "reference.stub_answers"
    import types

    import torch
    from benchlib import drive, runner
    panel = torch.zeros(5, 3)
    outs, p = drive.call_once(cell, [panel], 0, torch.device("cpu"))
    window = types.SimpleNamespace(sample=[(0, p, outs)], panels=[panel])
    assert runner.judge(cell, window) == {"rows_gap": 0.0}
    assert judge(cell.config, panel, control(cell.config, panel, None)) == \
        {"rows_gap": 1}
    # a bare name is the configuration's own reference
    cell.traffic["judge"] = "judge_fit"
    assert cell.reference_fn("judge").__module__ == "reference.arima"


def test_mix_keys_not_run_are_refused(tmp_path, monkeypatch):
    bench = _stub_tree(tmp_path, {
        "what": "x", "panels": 2, "keep": ["fit"], "callers": 8,
        "stages": [], "judge": "judge_fit", "control": "control_fit"})
    monkeypatch.setattr(spec, "BENCH", tmp_path)
    with pytest.raises(ValueError, match="callers"):
        spec.Cell("arima111_daily_1m.stub", bench)

"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole run after the look for a card
(``runner.run_cell`` on the CPU, cells cut to a size a test holds) with
one fault planted in the program: an optimizer step that returns its
state unchanged, half of the batch left out with the mean of the rest in
its place, and an answer altered where it is produced.  The cells run on
one card, so there is no exchange between cards to leave out.
"""

import time

import pytest
import torch

import _tiny
from benchlib import drive, runner


def _run(cell):
    return runner.run_cell(cell, 2 ** 31 + 3, 0.5, False, _tiny.cpu(),
                           time.perf_counter())


def _fit_entry(cell):
    return drive.resolve_call(cell.config["entries"]["fit"]["call"])


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_sound_run_judges(name):
    out = _run(_tiny.cell(name))
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"], out["checks"]


def test_traced_run_line():
    cell = _tiny.cell("arima111_daily_1m.fit")
    out = runner.run_cell(cell, 2 ** 31 + 4, 0.2, True, _tiny.cpu(),
                          time.perf_counter())
    assert list(out)[-1] == "checks"
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in cell.per_layer}
    assert set(out["metrics"]) <= names


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_step_returns_state_unchanged(name, monkeypatch):
    from spark_timeseries_tpu_torch.utils import optim
    monkeypatch.setattr(optim, "_step", lambda fb, state, k, **kw: state)
    assert not _run(_tiny.cell(name))["correct"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_half_the_batch_left_out(name, monkeypatch):
    cell = _tiny.cell(name)
    real = _fit_entry(cell)

    def half(y, *args, **kwargs):
        n = y.shape[0] // 2
        res = real(y[:n], *args, **kwargs)

        def fill(x):
            rest = x.double().nanmean(0) if x.is_floating_point() else x[0]
            return torch.cat([x, rest.to(x.dtype).expand_as(
                x[:y.shape[0] - n])])

        return type(res)(*(fill(f) for f in res))

    cell.config["entries"]["fit"] = dict(cell.config["entries"]["fit"],
                                         call="_fault.half")
    monkeypatch.setattr(drive, "resolve_call",
                        _with(drive.resolve_call, "_fault.half", half))
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_answer_altered_where_produced(name, monkeypatch):
    cell = _tiny.cell(name)
    real = _fit_entry(cell)

    def altered(y, *args, **kwargs):
        res = real(y, *args, **kwargs)
        p = res.params.clone()
        row = int(torch.isfinite(p).all(1).nonzero()[-1])
        p[row] = p[row].flip(0)  # the first and last parameters swapped
        return res._replace(params=p)

    cell.config["entries"]["fit"] = dict(cell.config["entries"]["fit"],
                                         call="_fault.altered")
    monkeypatch.setattr(drive, "resolve_call",
                        _with(drive.resolve_call, "_fault.altered", altered))
    assert not _run(cell)["correct"]


def test_return_altered_where_produced(monkeypatch):
    cell = _tiny.cell("garch11_vol_100k.pipeline")
    from spark_timeseries_tpu_torch.ops import univariate
    real = univariate.batch_fill_linear_chain

    def altered(panel, *args, **kwargs):
        out = real(panel, *args, **kwargs)
        r = out[0].clone()
        r[5, -1] += 0.5
        return (r,) + tuple(out[1:])

    monkeypatch.setattr(univariate, "batch_fill_linear_chain", altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["fill_err"]["value"] > \
        out["checks"]["fill_err"]["limit"]


def _with(resolve, name, fn):
    def wrapped(dotted):
        return fn if dotted == name else resolve(dotted)
    return wrapped

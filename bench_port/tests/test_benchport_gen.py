"""Each generator is deterministic in its seed and makes the configured
shape and missing-data share (on the CPU, with fewer rows)."""

import math

import pytest
import torch

from benchlib import spec

# (cell, rows for the test): the configured time axis, fewer rows
CASES = [("arima111_daily_1m.fit", 512), ("garch11_vol_100k.pipeline", 2000),
         ("hw_additive_hourly_1m.fit", 2000)]


@pytest.mark.parametrize("name,rows", CASES)
def test_deterministic_and_shaped(name, rows):
    cell = spec.Cell(name)
    cfg = dict(cell.config, rows=rows)
    seed = 2 ** 31 + 7
    a = cell.generator.make(cfg, seed, torch.device("cpu"))
    b = cell.generator.make(cfg, seed, torch.device("cpu"))
    c = cell.generator.make(cfg, seed + 1, torch.device("cpu"))
    assert a.shape == (rows, cfg["time"]) and a.dtype == torch.float32
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))
    assert not torch.equal(torch.nan_to_num(a), torch.nan_to_num(c))
    share = float(torch.isnan(a).float().mean())
    assert math.isclose(share, cfg["nan_share"], abs_tol=0.012), share


def test_garch_edge_rows_and_spans():
    cell = spec.Cell("garch11_vol_100k.pipeline")
    cfg = dict(cell.config, rows=2000, time=300)
    y = cell.generator.make(cfg, 5, torch.device("cpu"))
    assert int(torch.isnan(y).all(1).sum()) == 1  # never listed
    ends = torch.isnan(y[:, -1]) & ~torch.isnan(y).all(1)
    assert 5 < int(ends.sum()) < 100  # delistings, and gaps at the end
    z = cell.generator.make(cfg, 6, torch.device("cpu"))
    # every seed gets the same listing spans (a gap of up to 5 days at an
    # edge moves a span's observed end)
    for a, b in zip(_spans(y), _spans(z)):
        assert int((a - b).abs().max()) <= 5


def test_garch_panels_are_the_fixed_draws():
    cell = spec.Cell("garch11_vol_100k.pipeline")
    cell.config["rows"], cell.config["time"] = 300, 120
    draws = len(cell.config["generating"]["series_seeds"])
    assert cell.traffic["panels"] == draws == 4
    a = cell.make_panels(2 ** 31 + 9, torch.device("cpu"))
    b = cell.make_panels(2 ** 31 + 10, torch.device("cpu"))
    for k in range(draws):
        # the same draw in another row order: the same sorted values
        va, vb = (torch.nan_to_num(x[k], nan=-1e9).flatten().sort().values
                  for x in (a, b))
        assert torch.equal(va, vb)
        assert not torch.equal(torch.nan_to_num(a[k]), torch.nan_to_num(b[k]))
    assert not torch.equal(torch.nan_to_num(a[0]), torch.nan_to_num(a[1]))


def test_hourly_lengths_are_the_same_set():
    cell = spec.Cell("hw_additive_hourly_1m.fit")
    cfg = dict(cell.config, rows=500)
    a = cell.generator.make(cfg, 1, torch.device("cpu"))
    b = cell.generator.make(cfg, 2, torch.device("cpu"))
    na, nb = (~torch.isnan(a)).sum(1), (~torch.isnan(b)).sum(1)
    assert torch.equal(na.sort().values, nb.sort().values)
    assert not torch.equal(na, nb)


def _spans(y):
    """The sorted first and the sorted last valid positions of the rows."""
    t = torch.arange(y.shape[1])
    valid = ~torch.isnan(y)
    first = torch.where(valid, t, y.shape[1]).amin(1)
    last = torch.where(valid, t, -1).amax(1)
    return first.sort().values, last.sort().values


def test_panels_of_a_run_differ():
    cell = spec.Cell("arima111_daily_1m.fit")
    cell.config["rows"], cell.config["time"] = 32, 50
    p = cell.make_panels(3, torch.device("cpu"))
    assert len(p) == cell.traffic["panels"] == 2
    assert not torch.equal(p[0], p[1])

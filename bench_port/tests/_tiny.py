"""Cells cut to a size a CPU test can hold (the cell's own files, with
``rows`` and ``time`` replaced)."""

import torch

from benchlib import spec

SIZES = {"arima111_daily_1m.fit": (192, 1000),
         "garch11_vol_100k.pipeline": (192, 1000),
         "hw_additive_hourly_1m.fit": (128, 960)}
CELLS = tuple(SIZES)


def cell(name: str) -> spec.Cell:
    c = spec.Cell(name)
    c.config["rows"], c.config["time"] = SIZES[name]
    return c


def cpu() -> torch.device:
    return torch.device("cpu")

"""The lower-precision control (the plain reference in bfloat16, in the
program's place) comes out not correct, in every cell, at a size a CPU
test holds; and the program's own readings there are correct.  On the
card the same functions run at the cell's size:
``python3 bench_port/calibrate.py --workload <cell> --seeds ...
--control-seeds ...``.
"""

import pytest

import _tiny
import calibrate
from benchlib import runner


@pytest.mark.parametrize("name", _tiny.CELLS)
def test_bfloat16_control_fails(name):
    cell = _tiny.cell(name)
    nums = calibrate.control_numbers(cell, 2 ** 31 + 101, _tiny.cpu())
    correct, checks = runner.decide(nums, cell.limits)
    assert not correct, checks


def test_program_readings_pass():
    cell = _tiny.cell("arima111_daily_1m.fit")
    nums, walls = calibrate.program_numbers(cell, 2 ** 31 + 102, _tiny.cpu())
    assert len(walls) == cell.traffic["panels"]
    assert runner.decide(nums, cell.limits)[0], nums

"""On the card: one short run of each cell prints the result's last
line with ``correct`` true.  Skips without a CUDA device (decided inside
the test).  Run on the card with
``python -m pytest bench_port/tests -q -m card``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
CELLS = ("arima111_daily_1m.fit", "garch11_vol_100k.pipeline",
         "hw_additive_hourly_1m.fit")


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_short_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", name,
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=BENCH.parent, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]

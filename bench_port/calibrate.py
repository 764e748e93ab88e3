"""Readings for the limits of ``correct``: the program's numbers over
many seeds and the lower-precision control's, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

For each ``--seeds`` seed the cell's panels are made, each is called once
through the mix (the window's own calls, at the cell's size) and both
answers are judged as a run judges its sample.  For each
``--control-seeds`` seed the plain reference, computed in bfloat16 (the
precision below the configurations' float32), answers panel ``seed mod
panels`` in the program's place and is judged the same way.  One JSON line per seed,
then the largest program reading and the smallest control reading of
each number.
"""

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s.strip()]


def program_numbers(cell, seed: int, device) -> tuple:
    from benchlib import drive, runner
    panels = cell.make_panels(seed, device)
    walls, worst = [], {}
    for i in range(len(panels)):
        drive.sync(device)
        t0 = time.perf_counter()
        outs, p = drive.call_once(cell, panels, i, device)
        drive.sync(device)
        walls.append(time.perf_counter() - t0)
        fn = cell.reference_fn("judge")
        for k, v in fn(cell.config, panels[p], outs).items():
            v = math.inf if math.isnan(float(v)) else float(v)
            worst[k] = max(worst.get(k, -math.inf), v)
        del outs
        runner.free_memory(device)
    return worst, walls


def control_numbers(cell, seed: int, device) -> dict:
    import torch
    panels = cell.make_panels(seed, device)
    panel = panels[seed % len(panels)]  # seeds in a row: each panel
    del panels
    outs = cell.reference_fn("control")(cell.config, panel, torch.bfloat16)
    fn = cell.reference_fn("judge")
    return {k: (math.inf if math.isnan(float(v)) else float(v))
            for k, v in fn(cell.config, panel, outs).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(BENCH.parent), str(BENCH)]
    os.environ["USE_FLAX"] = "0"

    import torch
    from benchlib import spec
    from spark_timeseries_tpu_torch.utils import compile_cache
    compile_cache.enable_compile_cache(str(BENCH / ".cache" / "kernels"))
    cell = spec.Cell(args.workload)
    device = torch.device("cuda:0")
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec, default=str), flush=True)

    lower, upper = {}, {}
    for s in _seeds(args.seeds):
        nums, walls = program_numbers(cell, s, device)
        emit({"cell": cell.name, "kind": "program", "seed": s,
              "numbers": nums, "walls": walls})
        for k, v in nums.items():
            lower[k] = max(lower.get(k, -math.inf), v)
    for s in _seeds(args.control_seeds):
        t0 = time.perf_counter()
        nums = control_numbers(cell, s, device)
        emit({"cell": cell.name, "kind": "control", "dtype": "bfloat16",
              "seed": s, "numbers": nums,
              "seconds": time.perf_counter() - t0})
        for k, v in nums.items():
            upper[k] = min(upper.get(k, math.inf), v)
    emit({"cell": cell.name, "kind": "summary", "lower": lower,
          "upper": upper})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec, default=str) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

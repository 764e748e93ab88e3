#!/usr/bin/env python3
"""Time the volatility pipeline's transform kernels of several checkouts of
this repository in turns, on one GPU.

    python3 ab_transforms.py PARENT_DIR CHANGE_DIR [--rounds 2]

Runs one child process a checkout, in the order PARENT, CHANGE, CHANGE,
PARENT (``--rounds`` pairs of passes, the order reversed on every other
pass).  Each child imports ``spark_timeseries_tpu_torch`` from its checkout
(whose kernels it builds there), draws on the card the 100,000 x 2,520
ragged panel of daily log prices that ``chip_smoke.py`` times (seed 1), and
prints one JSON line with:

- the card's name and power limit (``nvidia-smi``);
- ``fill_chain`` (the difference only, as the pipeline runs it, and all
  three outputs) and ``autocorr`` (20 lags, on the returns) in ms: CUDA
  events over 20 launches after a warm-up;
- the walls of the pipeline's transform stages as ``chip_smoke.py`` phase
  5 runs them (fold, fill chain, autocorrelation of the returns and of
  their squares, unfold) on its seed-0 panel: host clock to a
  synchronise, best of three passes.

Each child also saves its returns' autocorrelation in a temporary
directory, and the parent process prints how far each checkout's lies
from the first one's, and whether the fill chain's outputs have the same
bits (a sha256 of them).  The last line is a JSON object ``{"runs":
[...]}`` with every child's numbers.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROWS, TIME, LAGS = 100_000, 2_520, 20


def _cuda_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def one(tree: Path, out: Path) -> dict:
    """The numbers of the checkout at ``tree`` (run in a child process)."""
    sys.path.insert(0, str(tree))
    import torch

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout
    from spark_timeseries_tpu_torch.ops import univariate as uv

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"tree": str(tree), "card": card}
    # the kernels, on chip_smoke.py's timing panel
    y = 100.0 * entry.gen_garch_prices(ROWS, TIME, seed=1, device=device)
    y[0] = float("nan")
    y[1] = 461.0
    y[2, TIME // 3:] = float("nan")
    yt = y.t().contiguous()
    del y
    diff = (False, True, False)
    (rt,) = ck.fill_chain(yt, diff)
    outs = ck.fill_chain(yt)
    h = hashlib.sha256()
    for o in (rt, *outs):
        h.update(o.cpu().numpy().tobytes())
    res["fill_sha256"] = h.hexdigest()
    del outs
    res["fill_chain_diff_ms"] = _cuda_ms(torch, lambda: ck.fill_chain(yt,
                                                                      diff))
    res["fill_chain_all_ms"] = _cuda_ms(torch, lambda: ck.fill_chain(yt))
    res["autocorr_ms"] = _cuda_ms(torch, lambda: ck.autocorr(rt, LAGS))
    torch.save(ck.autocorr(rt, LAGS).cpu(), out)
    del yt, rt
    # the pipeline's transform stages, as chip_smoke.py phase 5 runs them
    prices = entry.gen_garch_prices(ROWS, TIME, seed=0, device=device)
    walls = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        return value

    for _ in range(3):
        fp = timed("fold", lambda: layout.fold_panel(100.0 * prices))
        (ret_fp,) = timed("fill_chain", lambda: uv.batch_fill_linear_chain(
            fp, outputs=("diff",)))
        del fp
        timed("autocorr", lambda: uv.batch_autocorr(LAGS)(ret_fp))
        timed("autocorr_sq", lambda: uv.batch_autocorr(LAGS)(
            layout.FoldedPanel(ret_fp.data * ret_fp.data, ROWS, TIME)))
        timed("unfold", lambda: layout.unfold_panel(ret_fp))
        del ret_fp
    res["walls_s"] = {k: min(v) for k, v in walls.items()}
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve(), Path(argv[2]))))
        return 0
    rounds = 2
    if "--rounds" in argv:
        i = argv.index("--rounds")
        rounds = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    trees = [Path(a).resolve() for a in argv]
    if len(trees) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    order = []
    for r in range(2 * rounds):
        order += trees if r % 2 == 0 else trees[::-1]
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for n, tree in enumerate(order):
            acf = Path(tmp) / f"acf_{n}.pt"
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 str(tree), str(acf)], capture_output=True, text=True,
                timeout=1800)
            if proc.returncode:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: child failed "
                                   f"({proc.returncode})")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(run)
            print(f"{n}: {tree.name}: fill diff "
                  f"{run['fill_chain_diff_ms']:.4f} ms, all three "
                  f"{run['fill_chain_all_ms']:.4f} ms, autocorr "
                  f"{run['autocorr_ms']:.4f} ms; walls (s) "
                  f"{run['walls_s']}", flush=True)
        import torch

        first = torch.load(Path(tmp) / "acf_0.pt")
        for n, run in enumerate(runs):
            got = torch.load(Path(tmp) / f"acf_{n}.pt")
            nan = torch.isnan(first)
            same_nan = bool(torch.equal(torch.isnan(got), nan))
            err = float((got - first).masked_fill(nan, 0.0).abs().max())
            run["acf_max_abs_vs_first"] = err if same_nan else float("inf")
            run["fill_same_bits_as_first"] = (run["fill_sha256"]
                                              == runs[0]["fill_sha256"])
            same = "equal" if run["fill_same_bits_as_first"] else "DIFFER"
            print(f"{Path(run['tree']).name}: autocorr max |diff| vs the "
                  f"first run {run['acf_max_abs_vs_first']:.3e}, fill chain "
                  f"bits {same}")
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

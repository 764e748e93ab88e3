#!/usr/bin/env python3
"""Time the CSS kernels of several checkouts of this repository on the
airline model's work, in turns, on one GPU.

    python3 ab_css.py PARENT_DIR CHANGE_DIR [--rounds 1]

Runs one child process a checkout, in the order PARENT, CHANGE, CHANGE,
PARENT (``--rounds`` pairs of passes, the order reversed on every other
pass).  Each child imports ``spark_timeseries_tpu_torch`` from its checkout
(whose ``css.cu`` it builds there) and prints one JSON line with:

- the card's name and power limit (``nvidia-smi``);
- ``css_fwd`` ``sum`` and ``both`` and ``css_bwd`` with the per-series
  cotangent at the airline fit's shape [935, 1M] (the (0,1,1)(0,1,1,24)
  expansion, q_full = 25, of parameters drawn in (-0.8, 0.8) from seed
  25, on a ragged seed-26 panel) in ms: CUDA events over 10 launches after
  a warm-up.  A checkout whose ``css_fwd`` takes ``lags`` gets the
  model's structural support (MA lags 1, 24, 25), as its seasonal fit
  passes it;
- the register route beside it: ``css_fwd`` ``sum`` and ``css_bwd`` of
  ARMA(1,1) at the ARIMA path's shape [999, 1M] (seed 1), as
  ``chip_smoke.py`` phase 7 times them;
- the airline fit ``arima.fit(y, (0,1,1), seasonal=(0,1,1,24))`` of the
  1,000,000 x 960 hourly panel (seed 0), as ``chip_smoke.py`` phase 8b
  runs it: host clock to a synchronise, the second of two fits, with its
  iterations and status counts.

The parent process prints how far each checkout's per-series SSE and
gradient (of the coefficients at lags 0, 1, 24 and 25) lie from the first
run's, then, as its last line, a JSON object
``{"runs": [...]}`` with every child's numbers.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROWS, HOURLY_TIME, SEASON = 1_000_000, 960, 24


def _cuda_ms(torch, fn, reps: int = 10) -> float:
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
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"tree": str(tree), "card": card}
    order, seasonal = (0, 1, 1), (0, 1, 1, SEASON)
    p, q, _ = arima.seasonal_lag_span(order, seasonal)
    t = HOURLY_TIME - 1 - SEASON
    gen = torch.Generator(device=device)
    gen.manual_seed(26)
    y = torch.randn(ROWS, t, generator=gen, device=device)
    nv = t - torch.randint(0, t // 2, (ROWS,), generator=gen, device=device)
    yt, zb = layout.css_prefold(y, (p, 0, 1), nv.to(torch.int32))
    del y
    gen.manual_seed(25)
    k = arima._n_params_seasonal(order, seasonal, True)
    par = 1.6 * torch.rand(ROWS, k, generator=gen, device=device) - 0.8
    par[:, 0] *= 0.125
    params = arima._sarima_kernel_params(par, order, seasonal, True)
    kw = {}
    if "lags" in inspect.signature(ck.css_fwd).parameters:
        kw = {"lags": arima._lag_support(order, seasonal)}
    res["lags"] = kw.get("lags")
    e = ck.css_fwd(yt, params, zb, p, q, "e", **kw)
    gbar = torch.full((ROWS,), 1.0 / t, device=device)
    sse = ck.css_fwd(yt, params, zb, p, q, "sum", **kw)
    gpar = ck.css_bwd(yt, e, params, zb, gbar, p, q, **kw)[0]
    # the gradient of the coefficients the expansion can make non-zero
    cols = [0] + [p + j for j in (1, SEASON, SEASON + 1)]
    torch.save({"sse": sse.cpu(), "gpar": gpar[:, cols].cpu()}, out)
    res["css_fwd_sum_ms"] = _cuda_ms(
        torch, lambda: ck.css_fwd(yt, params, zb, p, q, "sum", **kw))
    res["css_fwd_both_ms"] = _cuda_ms(
        torch, lambda: ck.css_fwd(yt, params, zb, p, q, "both", **kw))
    res["css_bwd_ms"] = _cuda_ms(
        torch, lambda: ck.css_bwd(yt, e, params, zb, gbar, p, q, **kw))
    del yt, e, params, par
    # the register route at the ARIMA path's shape
    t = 999
    gen.manual_seed(1)
    y = torch.randn(ROWS, t, generator=gen, device=device)
    nv = t - torch.randint(0, t // 2, (ROWS,), generator=gen, device=device)
    yt, zb = layout.css_prefold(y, (1, 0, 1), nv.to(torch.int32))
    del y
    params = torch.stack([0.2 * torch.rand(ROWS, generator=gen, device=device)
                          - 0.1 for _ in range(3)], dim=1).contiguous()
    e = ck.css_fwd(yt, params, zb, 1, 1, "e")
    gbar = torch.full((ROWS,), 1.0 / t, device=device)
    res["register_fwd_sum_ms"] = _cuda_ms(
        torch, lambda: ck.css_fwd(yt, params, zb, 1, 1, "sum"))
    res["register_bwd_ms"] = _cuda_ms(
        torch, lambda: ck.css_bwd(yt, e, params, zb, gbar, 1, 1))
    del yt, e, params
    # the airline fit, as chip_smoke.py phase 8b runs it
    y = entry.gen_hourly_panel(ROWS, HOURLY_TIME, seed=0, device=device)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = arima.fit(y, order, seasonal=seasonal, device=device)
        torch.cuda.synchronize()
        res["airline_fit_s"] = time.perf_counter() - t0
    res["airline_iters"] = int(fit.iters.max())
    res["airline_status"] = {int(s): int(n) for s, n in zip(
        *torch.unique(fit.status, return_counts=True))}
    return res


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]).resolve(), Path(argv[2]))))
        return 0
    rounds = 1
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
            saved = Path(tmp) / f"css_{n}.pt"
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--one",
                 str(tree), str(saved)], capture_output=True, text=True,
                timeout=1800)
            if proc.returncode:
                print(proc.stdout, proc.stderr, file=sys.stderr)
                raise RuntimeError(f"{tree}: child failed "
                                   f"({proc.returncode})")
            run = json.loads(proc.stdout.strip().splitlines()[-1])
            runs.append(run)
            print(f"{n}: {tree.name}: css_fwd sum {run['css_fwd_sum_ms']:.3f}"
                  f" ms, both {run['css_fwd_both_ms']:.3f} ms, css_bwd "
                  f"{run['css_bwd_ms']:.3f} ms; register route sum "
                  f"{run['register_fwd_sum_ms']:.3f} ms, adjoint "
                  f"{run['register_bwd_ms']:.3f} ms; airline fit "
                  f"{run['airline_fit_s']:.3f} s, {run['airline_iters']} "
                  f"iterations, status {run['airline_status']}", flush=True)
        import torch

        first = torch.load(Path(tmp) / "css_0.pt")
        for n, run in enumerate(runs):
            got = torch.load(Path(tmp) / f"css_{n}.pt")
            for name in ("sse", "gpar"):
                scale = max(1.0, float(first[name].abs().max()))
                run[f"{name}_rel_vs_first"] = float(
                    (got[name] - first[name]).abs().max()) / scale
            print(f"{Path(run['tree']).name}: sse "
                  f"{run['sse_rel_vs_first']:.3e}, gparams "
                  f"{run['gpar_rel_vs_first']:.3e} relative to the first run")
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

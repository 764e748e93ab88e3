#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spark_timeseries_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; each failure makes the script exit non-zero with no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the three CUDA kernels from ``spark_timeseries_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds;
3. hold each kernel against its plain PyTorch version on the card, at
   B = 65,537 x T = 1,000 (ragged starts) and B = 4,097 x T = 3,000;
4. drive the main path: ``arima.fit`` of a 1,000,000 x 1,000 float32
   ARIMA(1,1,1) panel (the BASELINE.json headline) built on the card from a seeded generator, then
   ``arima.forecast(..., 30)``, with the kernel launch counts set to 0 just
   before and read just after; check the result (finite, plausible, and the
   kernel path against the eager path on a 4,096-row slice);
5. time each kernel at the main path's shape with CUDA events, beside its
   plain version and its bound (bytes over 3.35 TB/s, flops over the
   float32 rate, whichever is larger).

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROWS, TIME = 1_000_000, 1_000  # the main path's panel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

# Tolerances of kernel vs plain version, relative to the largest magnitude
# of the plain result.  The two differ only in rounding: the kernels' fused
# multiply-adds against PyTorch's separate multiply and add, over sums of
# up to T terms.
TOL = {"css_fwd": 1e-5, "css_bwd": 1e-5, "hr_moments": 1e-5}

REPLACES = {
    "css_fwd": "spark_timeseries_tpu/ops/pallas_kernels.py:229",
    "css_bwd": "spark_timeseries_tpu/ops/pallas_kernels.py:303",
    "hr_moments": "spark_timeseries_tpu/ops/pallas_kernels.py:1816",
}
SOURCES = {
    "css_fwd": "spark_timeseries_tpu_torch/csrc/css.cu",
    "css_bwd": "spark_timeseries_tpu_torch/csrc/css.cu",
    "hr_moments": "spark_timeseries_tpu_torch/csrc/hr.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` runs (one warm-up
    run first), from CUDA events."""
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


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, max abs error / max(1, max |ref|))."""
    got, ref = got.double(), ref.double()
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    scale = max(1.0, float(ref.abs().max()) if ref.numel() else 0.0)
    return err, err / scale


class Checks:
    """Collects kernel-vs-plain comparisons and phase failures."""

    def __init__(self):
        self.max_abs = {k: 0.0 for k in TOL}
        self.failures: list[str] = []

    def compare(self, kernel: str, what: str, got, ref) -> None:
        err, rel = rel_err(got, ref)
        self.max_abs[kernel] = max(self.max_abs[kernel], err)
        ok = rel <= TOL[kernel]
        log(f"  {kernel:10s} {what:34s} max_abs={err:.3e} rel={rel:.3e} "
            f"tol={TOL[kernel]:.0e} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{kernel} {what}: rel {rel:.3e}")

    def require(self, cond: bool, what: str) -> None:
        log(f"  check {what}: {'ok' if cond else 'FAIL'}")
        if not cond:
            self.failures.append(what)


def ragged_panel(b: int, t: int, p: int, seed: int, device):
    """Time-major ``[T, B]`` panel with ragged starts, in the kernels'
    layout (``css_prefold``), plus invertible ARMA(1,1) parameters."""
    from spark_timeseries_tpu_torch.ops import layout

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    y = torch.randn(b, t, generator=gen, device=device)
    nv = t - torch.randint(0, t // 2, (b,), generator=gen, device=device)
    yt, zb = layout.css_prefold(y, (p, 0, 1), nv.to(torch.int32))
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        b, generator=gen, device=device)
    params = torch.stack([u(-0.1, 0.1), u(-0.8, 0.8), u(-0.8, 0.8)], dim=1)
    return yt, zb, (t - nv).float(), params.contiguous()


def phase_kernels(chk: Checks, device) -> None:
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    p, q = 1, 1
    for b, t in ((65_537, 1_000), (4_097, 3_000)):
        log(f"phase 3: kernels vs plain at B={b} T={t}")
        yt, zb, start, params = ragged_panel(b, t, p, seed=b, device=device)
        for mode in ("e", "sum", "tail"):
            got = ck.css_fwd(yt, params, zb, p, q, mode)
            ref = ck.css_fwd_plain(yt, params, zb, p, q, mode)
            chk.compare("css_fwd", f"mode {mode}", got, ref)
        e_both, s_both = ck.css_fwd(yt, params, zb, p, q, "both")
        s_sum = ck.css_fwd(yt, params, zb, p, q, "sum")
        chk.require(torch.equal(s_both, s_sum), "css_fwd sum == both bitwise")
        chk.compare("css_fwd", "mode both (errors)", e_both,
                    ck.css_fwd_plain(yt, params, zb, p, q, "e"))
        e = ck.css_fwd_plain(yt, params, zb, p, q, "e")
        gen = torch.Generator(device=device)
        gen.manual_seed(7)
        gbar = torch.rand(b, generator=gen, device=device) / t
        gpan = torch.randn(t, b, generator=gen, device=device)
        for g, name in ((gbar, "per-series"), (gpan, "[T, B] panel")):
            gp, gy = ck.css_bwd(yt, e, params, zb, g, p, q, True)
            gp_r, gy_r = ck.css_bwd_plain(yt, e, params, zb, g, p, q, True)
            chk.compare("css_bwd", f"gparams, {name} cotangent", gp, gp_r)
            chk.compare("css_bwd", f"gy, {name} cotangent", gy, gy_r)
        m = 3  # the ARIMA(1,1,1) init: AR(3) stage 1, then [1, y, e] lags
        acc1 = ck.hr_moments(yt, start, m, 0, True, m)
        chk.compare("hr_moments", "stage 1 (AR(3))", acc1,
                    ck.hr_moments_plain(yt, start, m, 0, True, m))
        beta = (0.2 * torch.randn(b, m + 1, generator=gen, device=device)
                ).contiguous()
        acc2 = ck.hr_moments(yt, start, p, q, True, m + q, m, beta)
        chk.compare("hr_moments", "stage 2 (residual lags)", acc2,
                    ck.hr_moments_plain(yt, start, p, q, True, m + q, m,
                                        beta))
        del yt, e, gpan
        torch.cuda.synchronize()
    # other instantiations than the main path's: a wider register ring and
    # the local-memory rings past 8 lags; moment sweeps of 18 columns
    b, t = 4_097, 300
    log(f"phase 3: other orders at B={b} T={t}")
    gen = torch.Generator(device=device)
    gen.manual_seed(11)
    for p, q in ((3, 2), (10, 3)):
        yt, zb, start, _ = ragged_panel(b, t, p, seed=p, device=device)
        params = (0.1 * torch.randn(b, 1 + p + q, generator=gen,
                                    device=device)).contiguous()
        e = ck.css_fwd(yt, params, zb, p, q, "e")
        chk.compare("css_fwd", f"ARMA({p},{q}) errors", e,
                    ck.css_fwd_plain(yt, params, zb, p, q, "e"))
        gbar = torch.rand(b, generator=gen, device=device)
        gp, gy = ck.css_bwd(yt, e, params, zb, gbar, p, q, True)
        gp_r, gy_r = ck.css_bwd_plain(yt, e, params, zb, gbar, p, q, True)
        chk.compare("css_bwd", f"ARMA({p},{q}) gparams", gp, gp_r)
        chk.compare("css_bwd", f"ARMA({p},{q}) gy", gy, gy_r)
    m = 17  # the ARIMA(8,d,8) init's stage 1
    chk.compare("hr_moments", "stage 1 (AR(17), 18 columns)",
                ck.hr_moments(yt, start, m, 0, True, m),
                ck.hr_moments_plain(yt, start, m, 0, True, m))


def _parity(a, b) -> tuple[float, float]:
    """(|converged share difference|, median |param difference| over rows
    both converged)."""
    both = a.converged & b.converged
    diff = (a.params[both] - b.params[both]).abs()
    med = float(diff.median()) if diff.numel() else float("inf")
    return abs(float(a.converged.float().mean())
               - float(b.converged.float().mean())), med


def phase_main(chk: Checks, rows: int, t: int, device) -> dict:
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import status_counts
    from spark_timeseries_tpu_torch.utils import optim

    log(f"phase 4: main path, ARIMA(1,1,1) fit + forecast of {rows} x {t}")
    t0 = time.perf_counter()
    y = entry.gen_panel(rows, t, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"  panel built on the card in {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()

    ck.reset_launch_counts()
    optim.host_reads.count = 0
    t0 = time.perf_counter()
    res = arima.fit(y, entry.ORDER, device=device)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    reads = optim.host_reads.count
    t0 = time.perf_counter()
    fc = arima.forecast(res.params, y, entry.ORDER, 30, device=device)
    torch.cuda.synchronize()
    fc_s = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)

    counts = status_counts(res.status.cpu().numpy())
    conv = float(res.converged.float().mean())
    log(f"  fit wall {fit_s:.3f} s = {rows / fit_s:.1f} series/s; forecast "
        f"{fc_s:.3f} s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  status {counts}; converged share {conv:.4f}; iterations max "
        f"{int(res.iters.max())}")
    log(f"  optimizer host reads {reads}")
    log(f"  kernel launches on the main path {launches}")
    for name, n in launches.items():
        chk.require(n > 0, f"{name} launched on the main path ({n})")
    chk.require(tuple(res.params.shape) == (rows, 3)
                and bool(torch.isfinite(res.params).all()),
                "fit params finite, shape [B, 3]")
    chk.require(tuple(fc.shape) == (rows, 30)
                and bool(torch.isfinite(fc).all()),
                "forecast finite, shape [B, 30]")
    chk.require(conv > 0.9, f"converged share {conv:.4f} > 0.9")
    med = res.params.median(dim=0).values.tolist()
    log(f"  median params [c, phi, theta] = {med} (panel made with "
        "phi=0.6, theta=0.3)")
    chk.require(abs(med[1] - 0.6) < 0.05 and abs(med[2] - 0.3) < 0.05,
                "median phi, theta within 0.05 of the generating values")

    # the kernel path against the plain PyTorch path on a slice
    n = min(4096, rows)
    ys = y[:n].contiguous()
    r_cuda = arima.fit(ys, entry.ORDER, backend="cuda", device=device)
    r_eager = arima.fit(ys, entry.ORDER, backend="eager", device=device)
    dconv, med_dp = _parity(r_cuda, r_eager)
    log(f"  fit cuda vs eager on {n} rows: converged share differs by "
        f"{dconv:.4f}, median |param diff| {med_dp:.2e}")
    chk.require(dconv < 0.02 and med_dp < 1e-2,
                "fit cuda vs eager within the reference's parity bar")
    f_eager = arima.forecast(res.params[:n], ys, entry.ORDER, 30,
                             backend="eager", device=device)
    err, rel = rel_err(fc[:n], f_eager)
    log(f"  forecast cuda vs eager on {n} rows: max_abs={err:.3e} "
        f"rel={rel:.3e}")
    chk.require(bool(torch.allclose(fc[:n], f_eager, rtol=2e-4, atol=2e-4)),
                "forecast cuda vs eager within 2e-4")
    profile_fit(y, device)
    return {"launches": launches, "fit_s": fit_s, "forecast_s": fc_s,
            "host_reads": reads, "rows": rows, "time": t}


def _device_us(evt) -> float:
    return (getattr(evt, "device_time_total", None)
            or getattr(evt, "cuda_time_total", 0) or 0)


def profile_fit(y, device) -> None:
    """Where a warm fit's time goes: torch.profiler over one more fit of
    the same panel; device busy share and the top operations by device
    time (launch counts above are already read, so these do not count)."""
    from torch.profiler import ProfilerActivity, profile

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import arima

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        arima.fit(y, entry.ORDER, device=device)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: each CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    log(f"  profiled warm fit: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        log(f"    {_device_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls"
            f"  {e.key[:90]}")


def phase_timing(chk: Checks, main: dict, device) -> dict:
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    rows, t = main["rows"], main["time"]
    p, q, k = 1, 1, 3
    log(f"phase 5: kernel times at the main path's shape [T, B] = "
        f"[{t - 1}, {rows}] (ARIMA(1,1,1) after differencing)")
    T = t - 1
    yt, zb, start, params = ragged_panel(rows, T, p, seed=1, device=device)
    e = ck.css_fwd(yt, params, zb, p, q, "e")
    gbar = torch.full((rows,), 1.0 / T, device=device)
    m = 3
    beta = torch.full((rows, m + 1), 0.1, device=device)
    f, B = 4, rows  # bytes per float32, series
    n_el = T * B
    # each kernel against its plain version once more, at this shape
    chk.compare("css_fwd", "mode sum, main-path shape",
                ck.css_fwd(yt, params, zb, p, q, "sum"),
                ck.css_fwd_plain(yt, params, zb, p, q, "sum"))
    chk.compare("css_bwd", "gparams, main-path shape",
                ck.css_bwd(yt, e, params, zb, gbar, p, q)[0],
                ck.css_bwd_plain(yt, e, params, zb, gbar, p, q)[0])
    chk.compare("hr_moments", "stage 1, main-path shape",
                ck.hr_moments(yt, start, m, 0, True, m),
                ck.hr_moments_plain(yt, start, m, 0, True, m))
    chk.compare("hr_moments", "stage 2, main-path shape",
                ck.hr_moments(yt, start, p, q, True, m + q, m, beta),
                ck.hr_moments_plain(yt, start, p, q, True, m + q, m, beta))

    def bound(nbytes, flops):
        tb, to = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
        return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"

    out = {}
    # css_fwd, mode "sum": the objective every line-search trial evaluates.
    # reads y [T,B], params [B,k], zb [B]; writes sse [B]; per element
    # p+q multiply-adds, a subtract, a square-accumulate
    ms = cuda_ms(lambda: ck.css_fwd(yt, params, zb, p, q, "sum"))
    plain = cuda_ms(lambda: ck.css_fwd_plain(yt, params, zb, p, q, "sum"),
                    reps=1)
    out["css_fwd"] = (ms, plain, *bound(f * (n_el + B * k + 2 * B),
                                        n_el * (2 * (p + q) + 3)))
    for mode in ("both", "tail"):
        log(f"  css_fwd mode {mode}: "
            f"{cuda_ms(lambda: ck.css_fwd(yt, params, zb, p, q, mode)):.3f}"
            " ms")
    # css_bwd with the per-series cotangent: the fit's gradient.  reads y,
    # e [T,B], params, zb, gbar; writes gparams [B,k]; per element q + k
    # multiply-adds and a few adds
    ms = cuda_ms(lambda: ck.css_bwd(yt, e, params, zb, gbar, p, q))
    plain = cuda_ms(lambda: ck.css_bwd_plain(yt, e, params, zb, gbar, p, q),
                    reps=1)
    out["css_bwd"] = (ms, plain, *bound(f * (2 * n_el + 2 * B * k + 2 * B),
                                        n_el * (2 * (q + k) + 4)))
    log("  css_bwd with the data cotangent: "
        f"{cuda_ms(lambda: ck.css_bwd(yt, e, params, zb, gbar, p, q, True)):.3f}"
        " ms")
    del e
    # hr_moments, both sweeps of one init: each reads y once and writes its
    # accumulators; stage 1 has 14 sums (2 flops each), stage 2 9 sums plus
    # the AR(3) residual (8 flops)
    def hr_both():
        ck.hr_moments(yt, start, m, 0, True, m)
        ck.hr_moments(yt, start, p, q, True, m + q, m, beta)

    def hr_both_plain():
        ck.hr_moments_plain(yt, start, m, 0, True, m)
        ck.hr_moments_plain(yt, start, p, q, True, m + q, m, beta)

    ms = cuda_ms(hr_both)
    plain = cuda_ms(hr_both_plain, reps=1)
    out["hr_moments"] = (ms, plain, *bound(
        f * (2 * n_el + 3 * B + B * (m + 1) + B * (14 + 9)),
        n_el * (2 * 14 + 2 * 9 + 8)))
    for name, (ms, plain, bms, by) in out.items():
        log(f"  {name:10s} {ms:9.3f} ms  plain {plain:10.3f} ms  bound "
            f"{bms:.3f} ms ({by})  library: none (no single PyTorch call "
            "computes this function)")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from spark_timeseries_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    log(f"phase 2: built {sorted(logs) or 'nothing (up to date)'} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        frame = [int(n) for n in re.findall(r"(\d+) bytes stack frame", text)]
        spill = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"  {name}: {len(regs)} kernels, registers per thread "
            f"{min(regs, default=0)}..{max(regs, default=0)}, largest stack "
            f"frame {max(frame, default=0)} B, spill stores {sum(spill)} B")

    chk = Checks()
    phase_kernels(chk, device)
    if chk.failures:  # a kernel that disagrees makes the rest meaningless
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    main_run = phase_main(chk, ROWS, TIME, device)
    times = phase_timing(chk, main_run, device)
    if chk.failures:
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": main_run["launches"][name],
        "max_abs_err": chk.max_abs[name], "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    } for name, (ms, plain, bms, by) in times.items()]
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

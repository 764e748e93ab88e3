#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spark_timeseries_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; each failure makes the script exit non-zero with no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from the seven sources in
   ``spark_timeseries_tpu_torch/csrc`` (one ``nvcc`` per source, all at
   once) and print the build seconds and each source's registers, stack
   frames and spills (per instantiation for the Holt-Winters, GARCH,
   moment and transform kernels), and for the kernels that stream through
   a ring or a tile (GARCH, the Holt-Winters forward, the moment sweep,
   the fill chain, the autocorrelation, the CSS lag route) its shared
   memory, blocks an SM, SASS instructions a step and the issue-rate floor
   they imply;
3. hold each of the eleven kernels against its plain PyTorch version on the
   card, at B = 65,537 x T = 1,000 and B = 4,097 x T = 3,000 (ragged
   panels; for the transforms also all-NaN, constant and trailing-NaN rows,
   the fill chain bit for bit, the autocorrelation on both routes, the
   tile and, at B = 4,097 x T = 8,000, the stream;
   for the smoothing kernels a never-live row, a row shorter than two
   seasons and the register-ring and global-ring Holt-Winters routes; for
   the GARCH and multiplicative Holt-Winters forwards rows outside their
   fast divide's range, and that divide against ``__fdiv_rn`` bit for bit
   over 2^35 pseudo-random pairs each; the Holt-Winters forward bit for
   bit at every register period and the global route; the CSS kernels on
   their lag and local routes with seasonal expansions at T = 935, each
   with its structural lags and with every lag: the airline model's
   (q_full = 25) and (1,0,1)(1,1,1,24)'s (p_full = q_full = 25) at B =
   65,537, s = 7 and 52 at B = 16,385, and s = 168 (the local route)
   with its support at B = 4,097);
4. drive the ARIMA path: ``arima.fit`` of a 1,000,000 x 1,000 float32
   ARIMA(1,1,1) panel (the BASELINE.json headline) built on the card from a
   seeded generator, then ``arima.forecast(..., 30)``, with the kernel
   launch counts set to 0 just before and read just after; check the result
   (finite, plausible, and the kernel path against the eager path on a
   4,096-row slice); profile a warm fit;
5. drive the volatility pipeline the same way: a 100,000 x 2,520 ragged
   panel of daily log prices with GARCH(1,1) returns, folded once, then the
   fill chain (percent returns), the autocorrelation of the returns and of
   their squares, ``garch.fit``, ``garch.forecast(..., 30)`` and
   ``garch.fit_argarch``; check the estimates against the generating
   parameters and the kernel path against the eager path on a 4,096-row
   slice; profile a warm GARCH fit;
6. drive the hourly path the same way (BASELINE config 5): a 1,000,000 x
   960 ragged hourly panel drawn from additive Holt-Winters (period 24),
   then ``ewma.fit`` + ``ewma.forecast(..., 48)``, ``holtwinters.fit``
   (additive) + ``holtwinters.forecast(..., 48)`` and the multiplicative
   fit of the first 100,000 rows (three seeded starts); check the estimates
   against the generating parameters and the kernel path against the eager
   path on 2,048 rows (1,024 rows and one start for the multiplicative
   fit); fit SES on a local-level panel whose optimum alpha is interior
   (both backends); profile a warm additive fit;
7. time each kernel at its path's shape with CUDA events, beside its plain
   version and its bound (bytes over 3.35 TB/s, flops over the float32
   rate, whichever is larger), the multiplicative adjoint on the 100,000
   rows its fit takes; at the hourly path's shape first hold every
   smoothing-kernel variant that path runs against its plain version (the
   forward bit for bit) and count the rows the multiplicative forward
   walks again with ``__fdiv_rn``; time the CSS kernels' lag route at the
   airline fit's shape [935, 1M] (forward sum and both, adjoint), with
   the airline model's support and with every lag listed;
8. drive the order-search path: (a) ``arima.fit_grid`` of (1,1,0),
   (0,1,1), (1,1,1) and (2,1,2) over the 1,000,000 x 1,000 headline panel
   on the kernels with straggler compaction, held against the eager grid
   and against ``arima.fit`` on 4,096 rows; (b) the airline model
   ``arima.fit(y, (0,1,1), seasonal=(0,1,1,24))`` of the 1,000,000 x 960
   hourly panel (the lag route), held against eager on 2,048 rows; (c)
   the seasonal grid (0,1,1)(0,1,1,24), (1,1,0)(1,1,0,24),
   (1,1,1)(1,1,1,24) on the hourly panel's first 100,000 rows; (d) ADF and
   KPSS on the headline panel's levels and differences, Ljung-Box on the
   ARIMA fit's innovations, AR(2) and Cochrane-Orcutt fits of 100,000 x
   1,000 seeded rows, and the spline fill, PACF and cross-correlation on
   the volatility panel.  Launch counts of the CSS kernels (by route) are
   read for each fit, and (b) and (c) must have run on the lag route
   alone; warm fits of (a) and (b) are profiled.
9. drive the resilient fit path (``reliability.resilient_fit``: sanitize
   -> ``arima.fit`` -> retry ladder) on the 1,000,000 x 1,000 headline
   panel with the telemetry plane (``obs``) streaming JSONL and a
   Prometheus textfile into ``chiprun_out/chip_smoke_obs/``: on the clean
   panel it must equal a plain ``arima.fit`` bit for bit; on a copy with
   seeded data faults (interior NaN runs on 1 % of rows, inf spikes on
   0.1 %, constant and all-NaN rows on 0.05 % each) and ``failing_fit``
   on 3 x 8 rows (failure budgets 1, 2 and 99) the status counts must be
   exact, the primary and retry rungs must run the CSS kernels on the
   register route (the primary also ``hr_moments``) and the fallback rung
   on ``"eager"`` with no kernel, and the OK rows must match a plain fit
   of the sanitized panel; then ``tools/obs_report.py --check`` on the
   stream, the port's ``validate_textfile`` on the textfile, the device
   source of ``obs.peak_memory()``, the span names in a
   ``torch.profiler`` capture, the warm fit's wall with the plane off and
   on, and the kernel libraries' program-cache counts.

The line before the last is a JSON object with one entry per kernel, and
earlier lines JSON objects with the lag route's times, bounds and
launches and with phase 9's walls, launches and counts; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import ctypes
import functools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROWS, TIME = 1_000_000, 1_000  # the ARIMA path's panel
VOL_ROWS, VOL_TIME = 100_000, 2_520  # the volatility pipeline's panel
HOURLY_ROWS, HOURLY_TIME = 1_000_000, 960  # the hourly path's panel
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
# Tolerances of kernel vs plain version, relative to the largest magnitude
# of the plain result (NaNs must sit at the same places).  The two differ
# only in rounding: the kernels' fused multiply-adds against PyTorch's
# separate multiply and add, over sums of up to T terms.  The fill chain
# and the smoothing kernels round every operation as PyTorch does (_rn
# intrinsics), so they are held tighter (the fill chain and the
# Holt-Winters forward also bit for bit, by same_bits).  autocorr_plain
# sums in the kernel's order (chunks of the tile, then chunk order), so
# only the fused lag products differ: 1e-6 of r_k.
TOL = {"css_fwd": 1e-5, "css_bwd": 1e-5, "hr_moments": 1e-5,
       "fill_chain": 1e-6, "autocorr": 1e-6, "garch_fwd": 1e-5,
       "garch_bwd": 1e-5, "ewma_fwd": 1e-6, "ewma_bwd": 1e-6,
       "hw_fwd": 1e-6, "hw_bwd": 1e-6}

_PK = "spark_timeseries_tpu/ops/pallas_kernels.py"
REPLACES = {
    "css_fwd": f"{_PK}:229",
    "css_bwd": f"{_PK}:303",
    "hr_moments": f"{_PK}:1816",
    "fill_chain": f"{_PK}:1607",
    "autocorr": f"{_PK}:2004",
    "garch_fwd": f"{_PK}:716",
    "garch_bwd": f"{_PK}:769",
    "ewma_fwd": f"{_PK}:1016",
    "ewma_bwd": f"{_PK}:1062",
    "hw_fwd": f"{_PK}:1328",
    "hw_bwd": f"{_PK}:1387",
}
_CSRC = "spark_timeseries_tpu_torch/csrc"
SOURCES = {
    "css_fwd": f"{_CSRC}/css.cu",
    "css_bwd": f"{_CSRC}/css.cu",
    "hr_moments": f"{_CSRC}/hr.cu",
    "fill_chain": f"{_CSRC}/fill.cu",
    "autocorr": f"{_CSRC}/autocorr.cu",
    "garch_fwd": f"{_CSRC}/garch.cu",
    "garch_bwd": f"{_CSRC}/garch.cu",
    "ewma_fwd": f"{_CSRC}/ewma.cu",
    "ewma_bwd": f"{_CSRC}/ewma.cu",
    "hw_fwd": f"{_CSRC}/hw.cu",
    "hw_bwd": f"{_CSRC}/hw.cu",
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
    """(max abs error, max abs error / max(1, max |ref|)) over the entries
    where ``ref`` is not NaN; infinite when the NaNs do not match.  Walks
    the tensors in pieces of 2^26 elements: a [960, 1M] panel in float64
    would take 7.7 GB a copy."""
    if got.shape != ref.shape:
        return float("inf"), float("inf")
    err, scale = 0.0, 1.0
    for g, r in zip(got.reshape(-1).split(1 << 26),
                    ref.reshape(-1).split(1 << 26)):
        if not r.numel():
            continue
        g, r = g.double(), r.double()
        nan = torch.isnan(r)
        if not torch.equal(torch.isnan(g), nan):
            return float("inf"), float("inf")
        e = float((g - r).masked_fill_(nan, 0.0).abs().max())
        if not math.isfinite(e):  # an infinity on either side
            return float("inf"), float("inf")
        err = max(err, e)
        scale = max(scale, float(r.abs().masked_fill_(nan, 0.0).max()))
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

    log(f"phase 4: ARIMA path, ARIMA(1,1,1) fit + forecast of {rows} x {t}")
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
    log(f"  kernel launches on the ARIMA path {launches}")
    for name in ("css_fwd", "css_bwd", "hr_moments"):
        chk.require(launches[name] > 0,
                    f"{name} launched on the ARIMA path ({launches[name]})")
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
    profile_fit(lambda: arima.fit(y, entry.ORDER, device=device),
                "ARIMA fit")
    return {"launches": launches, "fit_s": fit_s, "forecast_s": fc_s,
            "params": res.params,
            "host_reads": reads, "rows": rows, "time": t}


def _device_us(evt) -> float:
    return (getattr(evt, "device_time_total", None)
            or getattr(evt, "cuda_time_total", 0) or 0)


def profile_fit(run, what: str) -> None:
    """Where a warm fit's time goes: torch.profiler over one more ``run()``;
    device busy share and the top operations by device time (launch counts
    are read before this, so these launches do not count)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: each CPU op's device time repeats its kernels'
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    log(f"  profiled warm {what}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    for e in sorted(kernels, key=_device_us, reverse=True)[:12]:
        log(f"    {_device_us(e) / 1e3:9.3f} ms device  {e.count:6d} calls"
            f"  {e.key[:90]}")


def _ragged_prices(b: int, t: int, seed: int, device):
    """Time-major ``[T, B]`` 100 x log-price panel with leading, interior
    and trailing NaN runs, plus an all-NaN row 0, a constant row 1 and a
    trailing-NaN row 2."""
    from spark_timeseries_tpu_torch import entry

    y = 100.0 * entry.gen_garch_prices(b, t, seed=seed, device=device)
    y[0] = float("nan")
    y[1] = 461.0
    y[2, t // 3:] = float("nan")
    return y.t().contiguous()


def phase_kernels_volatility(chk: Checks, device,
                             shapes=((65_537, 1_000), (4_097, 3_000))):
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    for b, t in shapes:
        log(f"phase 3: volatility kernels vs plain at B={b} T={t}")
        yt = _ragged_prices(b, t, seed=b, device=device)
        hold_fill_chain(chk, yt, f"B={b} T={t}")
        (rt,) = ck.fill_chain(yt, (False, True, False))  # returns, NaN edges
        del yt
        for nl in (1, 20, 24, 32, 40):
            chk.compare("autocorr",
                        f"returns, {nl} lags ({_acf_route(t, nl)})",
                        ck.autocorr(rt, nl), ck.autocorr_plain(rt, nl))
        chk.compare("autocorr", f"squared returns, 20 lags "
                    f"({_acf_route(t, 20)})",
                    ck.autocorr(rt * rt, 20), ck.autocorr_plain(rt * rt, 20))
        # GARCH: returns zeroed outside a ragged live span, a few rows live
        # from 0 and one never live
        gen = torch.Generator(device=device)
        gen.manual_seed(t)
        r = torch.randn(t, b, generator=gen, device=device)
        zb = torch.randint(0, t // 2, (b,), generator=gen,
                           device=device).float()
        zb[:3] = 0.0
        zb[3] = t + 1.0
        r.masked_fill_(torch.arange(t, device=device)[:, None] < zb, 0.0)
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            b, generator=gen, device=device)
        params = torch.stack([u(0.01, 0.2), u(0.02, 0.2), u(0.5, 0.78)],
                             dim=1).contiguous()
        h0 = u(0.5, 1.5)
        for mode in ("e", "sum", "last"):
            chk.compare("garch_fwd", f"mode {mode}",
                        ck.garch_fwd(r, params, h0, zb, mode),
                        ck.garch_fwd_plain(r, params, h0, zb, mode))
        h, s_both = ck.garch_fwd(r, params, h0, zb, "both")
        s_sum = ck.garch_fwd(r, params, h0, zb, "sum")
        chk.require(torch.equal(s_both, s_sum),
                    "garch_fwd sum == both bitwise")
        chk.compare("garch_fwd", "mode both (variances)", h,
                    ck.garch_fwd_plain(r, params, h0, zb, "e"))
        # rows whose r^2 or h leave the forward's fast divide: walked again
        # with __fdiv_rn; each row held on its own scale
        rx = r[:, :6].clone()
        rx[:, 0] = 1e-20  # r^2 subnormal
        rx[t // 2, 1] = 1e16  # r^2 and the next h above 2^60
        rx[:, 2] = 1e-30  # r^2 rounds to 0, inside the range
        rx[:, 3] *= 1e-12  # r^2 about 2^-80
        pe, he, ze = params[:6].contiguous(), h0[:6].contiguous(), zb[:6]
        s_e = ck.garch_fwd(rx, pe, he, ze, "sum")
        s_ref = ck.garch_fwd_plain(rx, pe, he, ze, "sum")
        chk.require(all(rel_err(s_e[i:i + 1], s_ref[i:i + 1])[1]
                        <= TOL["garch_fwd"] for i in range(6)),
                    "garch_fwd sum on rows outside the fast divide's range, "
                    "row by row")
        chk.require(torch.equal(ck.garch_fwd(rx, pe, he, ze, "both")[1], s_e),
                    "garch_fwd sum == both bitwise on those rows")
        gbar = torch.rand(b, generator=gen, device=device) / t
        gpan = torch.randn(t, b, generator=gen, device=device)
        for g, name in ((gbar, "per-series"), (gpan, "[T, B] panel")):
            for want in (False, True):
                got = ck.garch_bwd(r, params, h0, zb, h, g, want)
                ref = ck.garch_bwd_plain(r, params, h0, zb, h, g, want)
                what = f"{name} cotangent{', with dr' if want else ''}"
                chk.compare("garch_bwd", f"gparams, {what}", got[0], ref[0])
                chk.compare("garch_bwd", f"gh0, {what}", got[1], ref[1])
                if want:
                    chk.compare("garch_bwd", f"dr, {what}", got[2], ref[2])
        del r, h, gpan, rt
        torch.cuda.synchronize()
    # the autocorrelation's stream route: a T whose tile does not fit
    b, t = 4_097, 8_000
    log(f"phase 3: transforms vs plain at B={b} T={t}")
    yt = _ragged_prices(b, t, seed=t, device=device)
    hold_fill_chain(chk, yt, f"B={b} T={t}")
    (rt,) = ck.fill_chain(yt, (False, True, False))
    del yt
    for nl in (20, 40):
        chk.compare("autocorr", f"returns, {nl} lags ({_acf_route(t, nl)})",
                    ck.autocorr(rt, nl), ck.autocorr_plain(rt, nl))
    del rt
    torch.cuda.synchronize()


def _acf_route(t: int, nl: int) -> str:
    """The route the shipped autocorrelation kernel takes at (T, nl)."""
    from spark_timeseries_tpu_torch.ops import _build

    chunk = _build.load("autocorr").sts_autocorr_route(t, nl)
    return f"tile, chunks of {chunk}" if chunk else "stream"


def hold_fill_chain(chk: Checks, yt, what: str) -> None:
    """The fill chain against its plain version for each set of outputs,
    bit for bit."""
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    for which in ((True, True, True), (False, True, False),
                  (True, False, True), (False, False, True)):
        got = ck.fill_chain(yt, which)
        ref = ck.fill_chain_plain(yt, which)
        for i, (g, r) in enumerate(zip(got, ref)):
            chk.compare("fill_chain", f"outputs {which} #{i}", g, r)
        chk.require(all(same_bits(g, r) for g, r in zip(got, ref)),
                    f"fill_chain {which} bitwise equal to plain, {what}")
        del got, ref


def check_garch_divide(chk: Checks, device, pairs: int = 1 << 35) -> None:
    """The GARCH forward's branch-free divide against ``__fdiv_rn`` on the
    card, bit for bit, over ``pairs`` pseudo-random pairs."""
    from spark_timeseries_tpu_torch.ops import _build

    cnt = torch.zeros(2, dtype=torch.int64, device=device)
    rc = _build.load("garch").sts_garch_check_divide(
        pairs, 1, cnt.data_ptr(), cnt.data_ptr() + 8,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"sts_garch_check_divide failed: {rc}")
    tried, differ = cnt.tolist()
    log(f"  garch fast divide vs __fdiv_rn: {differ} of {tried} in-range "
        f"pairs differ ({pairs} drawn)")
    chk.require(differ == 0 and tried > pairs // 4,
                "garch fast divide bitwise equal to __fdiv_rn")


def check_hw_divide(chk: Checks, device, pairs: int = 1 << 35) -> None:
    """The Holt-Winters forward's branch-free divide against ``__fdiv_rn``
    on the card, bit for bit, over ``pairs`` pseudo-random pairs with
    numerators of either sign."""
    from spark_timeseries_tpu_torch.ops import _build

    cnt = torch.zeros(2, dtype=torch.int64, device=device)
    rc = _build.load("hw").sts_hw_check_divide(
        pairs, 2, cnt.data_ptr(), cnt.data_ptr() + 8,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"sts_hw_check_divide failed: {rc}")
    tried, differ = cnt.tolist()
    log(f"  hw fast divide vs __fdiv_rn: {differ} of {tried} in-range "
        f"pairs differ ({pairs} drawn, numerators of either sign)")
    chk.require(differ == 0 and tried > pairs // 4,
                "hw fast divide bitwise equal to __fdiv_rn")


def phase_pipeline(chk: Checks, rows: int, t: int, device) -> dict:
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import garch
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout
    from spark_timeseries_tpu_torch.ops import univariate as uv
    from spark_timeseries_tpu_torch.reliability import status_counts
    from spark_timeseries_tpu_torch.utils import optim

    log(f"phase 5: volatility pipeline on {rows} x {t} daily log prices")
    t0 = time.perf_counter()
    prices = entry.gen_garch_prices(rows, t, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"  panel built on the card in {time.perf_counter() - t0:.3f} s; "
        f"NaN share {float(torch.isnan(prices).float().mean()):.4f}")
    torch.cuda.reset_peak_memory_stats()
    walls, stage_launches = {}, {}

    def timed(name, fn):
        before = dict(ck.LAUNCHES)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        stage_launches[name] = {k: v - before[k] for k, v in
                                ck.LAUNCHES.items() if v > before[k]}
        return out

    ck.reset_launch_counts()
    optim.host_reads.count = 0
    fp = timed("fold", lambda: layout.fold_panel(100.0 * prices))
    (ret_fp,) = timed("fill_chain", lambda: uv.batch_fill_linear_chain(
        fp, outputs=("diff",)))
    del fp
    acf_r = timed("autocorr", lambda: uv.batch_autocorr(20)(ret_fp))
    acf_sq = timed("autocorr_sq", lambda: uv.batch_autocorr(20)(
        layout.FoldedPanel(ret_fp.data * ret_fp.data, rows, t)))
    returns = timed("unfold", lambda: layout.unfold_panel(ret_fp))
    del ret_fp
    res = timed("garch_fit", lambda: garch.fit(returns, device=device))
    reads = optim.host_reads.count
    fc = timed("garch_forecast", lambda: garch.forecast(
        res.params, returns, 30, device=device))
    ares = timed("argarch_fit", lambda: garch.fit_argarch(returns,
                                                          device=device))
    launches = dict(ck.LAUNCHES)

    log("  walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    log(f"  kernel launches on the pipeline {launches}; by stage "
        f"{stage_launches}")
    for name in ("fill_chain", "autocorr", "garch_fwd", "garch_bwd"):
        chk.require(launches[name] > 0,
                    f"{name} launched on the pipeline ({launches[name]})")
    # the transforms: GARCH returns are uncorrelated, their squares are not
    med_r = float(acf_r.abs().nanmedian())
    med_sq1 = float(acf_sq[:, 0].nanmedian())
    log(f"  autocorr: median |r_k| of returns {med_r:.4f}; median lag-1 "
        f"autocorrelation of squares {med_sq1:.4f}")
    chk.require(tuple(acf_r.shape) == (rows, 20) and med_r < 0.05,
                "returns' autocorrelation [B, 20], median |r_k| < 0.05")
    chk.require(med_sq1 > 0.05, "squared returns autocorrelated (ARCH "
                "effect): median lag-1 > 0.05")
    # the GARCH fit against the generating parameters
    omega, alpha, beta = entry.GARCH_PARAMS
    counts = status_counts(res.status.cpu().numpy())
    conv = float(res.converged.float().mean())
    med = res.params.nanmedian(dim=0).values.tolist()
    log(f"  garch.fit: {walls['garch_fit']:.3f} s = "
        f"{rows / walls['garch_fit']:.1f} series/s; status {counts}; "
        f"converged share {conv:.4f}; iterations max {int(res.iters.max())};"
        f" host reads {reads}")
    log(f"  median [omega, alpha, beta] = {med} (panel made with "
        f"{list(entry.GARCH_PARAMS)})")
    chk.require(tuple(res.params.shape) == (rows, 3), "fit params [B, 3]")
    chk.require(conv > 0.9, f"GARCH converged share {conv:.4f} > 0.9")
    chk.require(abs(med[1] - alpha) < 0.03 and abs(med[2] - beta) < 0.03,
                "median alpha, beta within 0.03 of the generating values")
    # the forecast decays toward omega / (1 - alpha - beta), row by row
    good = torch.isfinite(res.params).all(1)
    p = res.params
    uncond = p[:, 0] / (1.0 - p[:, 1] - p[:, 2])
    decays = ((fc[:, -1] - uncond).abs()
              <= (fc[:, 0] - uncond).abs() * (1 + 1e-5) + 1e-6)
    chk.require(tuple(fc.shape) == (rows, 30)
                and bool(torch.isfinite(fc[good]).all()),
                "forecast [B, 30], finite wherever the fit is")
    chk.require(bool(decays[good].all()),
                "forecast decays toward omega / (1 - alpha - beta)")
    log(f"  forecast: median h_1 {float(fc[good, 0].median()):.4f}, median "
        f"h_30 {float(fc[good, -1].median()):.4f}, median unconditional "
        f"{float(uncond[good].median()):.4f}")
    # ARGARCH: the AR(1) mean is 0 on these returns
    aconv = float(ares.converged.float().mean())
    amed = ares.params.nanmedian(dim=0).values.tolist()
    afin = float(torch.isfinite(ares.params).all(1).float().mean())
    log(f"  garch.fit_argarch: {walls['argarch_fit']:.3f} s; status "
        f"{status_counts(ares.status.cpu().numpy())}; converged share "
        f"{aconv:.4f}; median [c, phi, omega, alpha, beta] = {amed}")
    chk.require(tuple(ares.params.shape) == (rows, 5) and afin > 0.9,
                "ARGARCH params [B, 5], finite share > 0.9")
    chk.require(abs(amed[3] - alpha) < 0.05 and abs(amed[4] - beta) < 0.05,
                "ARGARCH median alpha, beta within 0.05")

    # the kernel path against the eager path on a slice
    n = min(4096, rows)
    rs = returns[:n].contiguous()
    (r_e,) = uv.batch_fill_linear_chain(100.0 * prices[:n], "eager",
                                        ("diff",))
    err, rel = rel_err(rs, r_e)
    log(f"  fill chain cuda vs eager on {n} rows: max_abs={err:.3e}")
    chk.require(rel <= 1e-5, "fill chain cuda vs eager within 1e-5")
    err, rel = rel_err(acf_r[:n], uv.batch_autocorr(20, "eager")(rs))
    log(f"  autocorr cuda vs eager on {n} rows: max_abs={err:.3e}")
    chk.require(rel <= 1e-4, "autocorr cuda vs eager within 1e-4")
    for name, fit in (("garch.fit", garch.fit),
                      ("garch.fit_argarch", garch.fit_argarch)):
        t0 = time.perf_counter()
        r_cuda = fit(rs, backend="cuda", device=device)
        t1 = time.perf_counter()
        r_eager = fit(rs, backend="eager", device=device)
        t2 = time.perf_counter()
        dconv, med_dp = _parity(r_cuda, r_eager)
        log(f"  {name} cuda vs eager on {n} rows ({t1 - t0:.2f} s vs "
            f"{t2 - t1:.2f} s): converged share differs by {dconv:.4f}, "
            f"median |param diff| {med_dp:.2e}")
        chk.require(dconv < 0.02 and med_dp < 1e-2,
                    f"{name} cuda vs eager within slice 1's parity bar")
    f_eager = garch.forecast(res.params[:n], rs, 30, backend="eager",
                             device=device)
    err, rel = rel_err(fc[:n], f_eager)
    log(f"  forecast cuda vs eager on {n} rows: max_abs={err:.3e} "
        f"rel={rel:.3e}")
    chk.require(rel <= 1e-4, "forecast cuda vs eager within 1e-4")
    del prices, r_e
    profile_fit(lambda: garch.fit(returns, device=device), "GARCH fit")
    return {"launches": launches, "walls": walls, "rows": rows, "time": t}


def phase_timing_volatility(chk: Checks, pipe: dict, device) -> dict:
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    rows, t = pipe["rows"], pipe["time"]
    log(f"phase 7: volatility kernel times at the pipeline's shape [T, B] = "
        f"[{t}, {rows}]")
    yt = _ragged_prices(rows, t, seed=1, device=device)
    B, n_el, f = rows, t * rows, 4
    nl = 20
    (rt,) = ck.fill_chain(yt, (False, True, False))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    zb = torch.randint(0, t // 2, (B,), generator=gen, device=device).float()
    rz = torch.nan_to_num(rt).masked_fill_(
        torch.arange(t, device=device)[:, None] < zb, 0.0)
    params = torch.tensor([0.05, 0.08, 0.9], device=device).repeat(B, 1)
    h0 = torch.full((B,), 2.5, device=device)
    gbar = torch.full((B,), 0.5 / t, device=device)
    h = ck.garch_fwd(rz, params, h0, zb, "e")
    # each kernel against its plain version once more, at this shape
    rt_plain = ck.fill_chain_plain(yt, (False, True, False))[0]
    chk.compare("fill_chain", "diff only, pipeline shape", rt, rt_plain)
    chk.require(same_bits(rt, rt_plain),
                "fill_chain diff only bitwise equal to plain, pipeline shape")
    del rt_plain
    chk.compare("autocorr", f"20 lags, pipeline shape ({_acf_route(t, nl)})",
                ck.autocorr(rt, nl), ck.autocorr_plain(rt, nl))
    # every variant the pipeline launches: sum (line-search trials), both
    # (gradient evaluations), last (the forecast), and the adjoint's three
    # outputs (dr carries ARGARCH's gradient)
    for mode in ("sum", "last"):
        chk.compare("garch_fwd", f"mode {mode}, pipeline shape",
                    ck.garch_fwd(rz, params, h0, zb, mode),
                    ck.garch_fwd_plain(rz, params, h0, zb, mode))
    got, ref = (ck.garch_fwd(rz, params, h0, zb, "both"),
                ck.garch_fwd_plain(rz, params, h0, zb, "both"))
    for i, what in enumerate(("variances", "sum")):
        chk.compare("garch_fwd", f"mode both ({what}), pipeline shape",
                    got[i], ref[i])
    del got, ref
    got = ck.garch_bwd(rz, params, h0, zb, h, gbar, True)
    ref = ck.garch_bwd_plain(rz, params, h0, zb, h, gbar, True)
    for i, what in enumerate(("gparams", "gh0", "dr")):
        chk.compare("garch_bwd", f"{what}, with dr, pipeline shape",
                    got[i], ref[i])
    del got, ref

    out = {}
    # fill chain as the pipeline calls it (the difference only): reads the
    # panel, writes one output; a compare, a subtract and a select per
    # element (the gap arithmetic touches ~2 % of them)
    which = (False, True, False)
    ms = cuda_ms(lambda: ck.fill_chain(yt, which))
    plain = cuda_ms(lambda: ck.fill_chain_plain(yt, which), reps=1)
    out["fill_chain"] = (ms, plain, *_bound(f * 2 * n_el, 3 * n_el))
    ms3 = cuda_ms(lambda: ck.fill_chain(yt))
    log(f"  fill_chain, all three outputs: {ms3:.3f} ms (bound "
        f"{_bound(f * 4 * n_el, 5 * n_el)[0]:.3f} ms)")
    # the same panel with no NaN: what the runs of NaN cost
    dense = torch.nan_to_num(yt, nan=500.0)
    log("  fill_chain on the panel with its NaN replaced: diff only "
        f"{cuda_ms(lambda: ck.fill_chain(dense, which)):.3f} ms, all three "
        f"{cuda_ms(lambda: ck.fill_chain(dense)):.3f} ms")
    del dense
    del yt
    # autocorrelation: one read of the panel, nl outputs per series; per
    # element the valid test and mean sum, the centring, the square and nl
    # lag products (2 flops each)
    ms = cuda_ms(lambda: ck.autocorr(rt, nl))
    plain = cuda_ms(lambda: ck.autocorr_plain(rt, nl), reps=1)
    out["autocorr"] = (ms, plain, *_bound(f * (n_el + nl * B),
                                          (2 * nl + 5) * n_el))
    del rt
    # GARCH, every variant the pipeline launches.  Forward: reads r, the
    # parameters, h0 and zb, writes ll (sum, every line-search trial), ll
    # and h (both, every gradient evaluation) or h_T (last, the forecast);
    # per element the square, the recursion (2 multiply-adds), the clamp,
    # the log, a multiply, a divide and two adds.  Adjoint with the
    # per-series cotangent (the fit's gradient): reads r and h, writes 4
    # sums per series; ~20 flops an element, and the dr panel for ARGARCH
    garch = {
        "fwd sum": (lambda: ck.garch_fwd(rz, params, h0, zb, "sum"),
                    f * (n_el + 6 * B), 11 * n_el),
        "fwd both": (lambda: ck.garch_fwd(rz, params, h0, zb, "both"),
                     f * (2 * n_el + 6 * B), 11 * n_el),
        "fwd last": (lambda: ck.garch_fwd(rz, params, h0, zb, "last"),
                     f * (n_el + 6 * B), 5 * n_el),
        "bwd": (lambda: ck.garch_bwd(rz, params, h0, zb, h, gbar),
                f * (2 * n_el + 10 * B), 20 * n_el),
        "bwd dr": (lambda: ck.garch_bwd(rz, params, h0, zb, h, gbar, True),
                   f * (3 * n_el + 10 * B), 24 * n_el),
    }
    garch_ms = {}
    for name, (fn, nbytes, flops) in garch.items():
        ms = garch_ms[name] = cuda_ms(fn)
        bms, by = _bound(nbytes, flops)
        log(f"  garch_{name:9s} {ms:.3f} ms = {nbytes / ms / 1e9:.3f} TB/s, "
            f"{100 * bms / ms:.1f} % of its bound {bms:.3f} ms ({by})")
    plain = cuda_ms(lambda: ck.garch_fwd_plain(rz, params, h0, zb, "sum"),
                    reps=1)
    out["garch_fwd"] = (garch_ms["fwd sum"], plain,
                        *_bound(*garch["fwd sum"][1:]))
    plain = cuda_ms(lambda: ck.garch_bwd_plain(rz, params, h0, zb, h, gbar),
                    reps=1)
    out["garch_bwd"] = (garch_ms["bwd"], plain, *_bound(*garch["bwd"][1:]))
    for name, (ms, plain, bms, by) in out.items():
        log(f"  {name:10s} {ms:9.3f} ms  plain {plain:10.3f} ms  bound "
            f"{bms:.3f} ms ({by})  library: none (no single PyTorch call "
            "computes this function)")
    # the same forward over 4x the series: how far the rate still follows
    # the number of threads rather than the memory
    del h, rz
    b4 = 4 * B
    r4 = torch.randn(t, b4, device=device)
    p4, z4 = params.repeat(4, 1), zb.repeat(4)
    ms4 = cuda_ms(lambda: ck.garch_fwd(r4, p4, h0.repeat(4), z4, "sum"))
    log(f"  garch_fwd sum at B={b4}: {ms4:.3f} ms = "
        f"{4 * t * b4 / ms4 / 1e9:.3f} TB/s (at B={B}: "
        f"{4 * n_el / out['garch_fwd'][0] / 1e9:.3f} TB/s)")
    return out


def _seasonal_rows(b: int, t: int, seed: int, device):
    """A positive hourly panel (level, trend, a daily sine of random
    amplitude and phase, unit noise), aligned as the fits align it ->
    ``(ya [B, T], nv)``: the valid span right-aligned, the prefix zeroed.
    Starts are ragged; row 0 is all NaN (never live), row 1 forty hours
    long (shorter than two days: clamped seed windows), row 2 dense."""
    from spark_timeseries_tpu_torch.models import base

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        b, 1, generator=gen, device=device)
    tt = torch.arange(t, device=device, dtype=torch.float32)[None, :]
    y = (u(400.0, 600.0) + u(-0.02, 0.02) * tt
         + u(10.0, 50.0) * torch.sin(2 * math.pi * tt / 24 + u(0.0, 6.3))
         + torch.randn(b, t, generator=gen, device=device))
    nv = torch.randint(t // 2, t + 1, (b,), generator=gen, device=device)
    nv[0], nv[1], nv[2] = 0, 40, t
    y.masked_fill_(tt < (t - nv)[:, None], float("nan"))
    return base.align_right(y)


def _local_level_rows(b: int, t: int, seed: int, device):
    """``([B, T] panel, optimal SES alpha)``: a random-walk level (steps of
    sd 0.5) plus unit noise around 100, ragged like the hourly panel
    (leading NaN runs of 0 to 28 % of T)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    q = 0.25  # level variance over noise variance
    y = (100.0 + (q ** 0.5 * torch.randn(b, t, generator=gen, device=device)
                  ).cumsum(1)
         + torch.randn(b, t, generator=gen, device=device))
    nv = torch.randint(t * 700 // 960, t + 1, (b,), generator=gen,
                       device=device)
    tt = torch.arange(t, device=device)[None, :]
    y.masked_fill_(tt < (t - nv)[:, None], float("nan"))
    return y, ((q * q + 4 * q) ** 0.5 - q) / 2


def phase_kernels_smoothing(chk: Checks, device,
                            shapes=((65_537, 1_000), (4_097, 3_000))):
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout

    for i, (b, t) in enumerate(shapes):
        log(f"phase 3: smoothing kernels vs plain at B={b} T={t}")
        ya, nv = _seasonal_rows(b, t, seed=b, device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(t)
        # EWMA: every mode, both cotangents, with and without the data's
        xt, zb = ck.ewma_prefold(ya, nv)
        alpha = 0.05 + 0.9 * torch.rand(b, generator=gen, device=device)
        for mode in ("e", "sum"):
            chk.compare("ewma_fwd", f"mode {mode}",
                        ck.ewma_fwd(xt, alpha, zb, mode),
                        ck.ewma_fwd_plain(xt, alpha, zb, mode))
        s, s_both = ck.ewma_fwd(xt, alpha, zb, "both")
        chk.require(torch.equal(s_both, ck.ewma_fwd(xt, alpha, zb, "sum")),
                    "ewma_fwd sum == both bitwise")
        chk.compare("ewma_fwd", "mode both (smoothed)", s,
                    ck.ewma_fwd_plain(xt, alpha, zb, "e"))
        gbar = torch.rand(b, generator=gen, device=device) / t
        gpan = torch.randn(t, b, generator=gen, device=device)
        for g, name in ((gbar, "per-series"), (gpan, "[T, B] panel")):
            for want in (False, True):
                got = ck.ewma_bwd(xt, s, alpha, zb, g, want)
                ref = ck.ewma_bwd_plain(xt, s, alpha, zb, g, want)
                what = f"{name} cotangent{', with gx' if want else ''}"
                chk.compare("ewma_bwd", f"galpha, {what}", got[0], ref[0])
                if want:
                    chk.compare("ewma_bwd", f"gx, {what}", got[1], ref[1])
        del xt, s, gpan, got, ref
        # Holt-Winters: both model types on the register-ring route (the
        # path's period 24, and 7) and the global-ring route (period 10);
        # the forward alone at the other register periods and period 25
        yt = layout.time_major(ya)
        if i == 0:
            for m in (4, 6, 8, 12, 25):
                for mult in (False, True):
                    par = (torch.tensor([0.05, 0.01, 0.05], device=device)
                           + torch.tensor([0.4, 0.3, 0.4], device=device)
                           * torch.rand(b, 3, generator=gen, device=device))
                    hold_hw_fwd(chk, yt, par, ck.hw_seeds(ya, m, mult, nv),
                                m, mult, f"m={m}, "
                                f"{'mult' if mult else 'add'}")
            hold_hw_exact_walk(chk, t, device)
        for m in ((24, 7, 10) if i == 0 else (24, 10)):
            route = ("registers" if ck.hw_ring_in_registers(m)
                     else "global ring")
            for mult in (False, True):
                # inside the stable region (alpha + gamma < 1): an
                # unstable recursion overflows the SSE over 3,000 steps
                par = (torch.tensor([0.05, 0.01, 0.05], device=device)
                       + torch.tensor([0.4, 0.3, 0.4], device=device)
                       * torch.rand(b, 3, generator=gen, device=device))
                hold_hw(chk, yt, par, ck.hw_seeds(ya, m, mult, nv), m, mult,
                        gen, f"m={m} {route}, {'mult' if mult else 'add'}")
        del ya, yt
        torch.cuda.synchronize()


def same_bits(a, b) -> bool:
    """The same float32 bits at every place (-0 and +0 differ), NaNs of any
    payload at the same places."""
    if a.shape != b.shape:
        return False
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a.masked_fill(nan, 0.0).view(torch.int32),
                            b.masked_fill(nan, 0.0).view(torch.int32)))


def hold_hw_fwd(chk: Checks, yt, par, seeds, m: int, mult: bool,
                kind: str):
    """The Holt-Winters forward against its plain version, bit for bit:
    the five save_resid outputs and the value-only SSE -> the kernel's
    save_resid outputs."""
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    got = ck.hw_fwd(yt, par, *seeds, m, mult, True)
    ref = ck.hw_fwd_plain(yt, par, *seeds, m, mult, True)
    for name, a, r in zip(("e", "L", "T", "S_old", "sse"), got, ref):
        chk.compare("hw_fwd", f"{name}, {kind}", a, r)
    chk.require(all(same_bits(a, r) for a, r in zip(got, ref))
                and same_bits(ck.hw_fwd(yt, par, *seeds, m, mult), ref[-1]),
                f"hw_fwd save_resid and sum bitwise equal to the plain "
                f"version, {kind}")
    return got


def _hw_lib_fwd(lib, yt, params, seeds, m: int, mult: bool, save: bool,
                walked=None):
    """A closure launching the Holt-Winters forward of ``lib`` (a build of
    ``hw.cu``, called directly) on these inputs -> its outputs as
    ``hw_fwd`` returns them (a list); ``walked`` (int32 ``[B]``), when
    given, gets 1 where the kernel redid a series with ``__fdiv_rn``."""
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    par = params.contiguous()

    def call():
        sse = yt.new_empty(yt.shape[1])
        outs = [torch.empty_like(yt) for _ in range(4)] if save else None
        rc = ck._hw_fwd_call(lib, torch.cuda.current_stream().cuda_stream, yt,
                             par, *seeds, m, mult, sse, outs, walked)
        if rc:
            raise RuntimeError(f"hw_fwd launch failed with CUDA error {rc}")
        return (outs or []) + [sse]
    return call


def hold_hw_exact_walk(chk: Checks, t: int, device) -> None:
    """Multiplicative rows whose divides leave the forward's fast path (a
    numerator below 2^-60, one above 2^60, a -0 numerator, a denominator
    above 2^60) are walked again with ``__fdiv_rn``; a negative numerator
    in range stays fast.  Each row bit for bit against the plain version,
    in both modes, and the kernel's own flags of the rows it redid."""
    from spark_timeseries_tpu_torch.ops import _build
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout

    m = 24
    ya, nv = _seasonal_rows(8, t, seed=5, device=device)
    l0, t0, s0r, zb = ck.hw_seeds(ya, m, True, nv)
    yt = layout.time_major(ya)
    par = torch.tensor([0.3, 0.05, 0.2], device=device).repeat(8, 1)
    yt[:, 3] *= 1e-27
    par[4, 0] = 0.5
    yt[t - 1, 4] = 2.4e18
    yt[t - 1, 5] = -0.0
    yt[t - 2, 6] = -3.0
    s0r[7] = 1e19
    seeds = (l0, t0, s0r, zb)
    walked = torch.full((8,), -1, dtype=torch.int32, device=device)
    for save in (False, True):
        got = _hw_lib_fwd(_build.load("hw"), yt, par, seeds, m, True, save,
                          walked)()
        ref = ck.hw_fwd_plain(yt, par, *seeds, m, True, save)
        ref = list(ref) if save else [ref]
        chk.require(all(same_bits(g[..., i], r[..., i])
                        for g, r in zip(got, ref) for i in range(8)),
                    f"hw_fwd {'save_resid' if save else 'sum'} on rows "
                    "outside the fast divide's range, row by row bitwise")
        chk.require(walked.tolist() == [0, 0, 0, 1, 1, 1, 0, 1],
                    f"hw_fwd redid exactly the rows outside the range "
                    f"({walked.tolist()})")


def hold_hw(chk: Checks, yt, par, seeds, m: int, mult: bool, gen,
            kind: str) -> None:
    """Both Holt-Winters kernels against their plain versions on one
    panel: the forward bit for bit (hold_hw_fwd), and the adjoint from the
    per-series and from a [T, B] cotangent."""
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    t, b = yt.shape
    l0, t0, _, zbh = seeds
    e, lv, tr, so, _ = hold_hw_fwd(chk, yt, par, seeds, m, mult, kind)
    gbar = torch.rand(b, generator=gen, device=yt.device) / t
    gpan = torch.randn(t, b, generator=gen, device=yt.device)
    for g, name in ((gbar, "per-series"), (gpan, "[T, B]")):
        chk.compare("hw_bwd", f"gparams, {name} cotangent, {kind}",
                    ck.hw_bwd(yt, par, l0, t0, zbh, lv, tr, so, e, g, m,
                              mult),
                    ck.hw_bwd_plain(yt, par, l0, t0, zbh, lv, tr, so, e, g,
                                    m, mult))


def phase_hourly(chk: Checks, rows: int, t: int, device) -> dict:
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import ewma
    from spark_timeseries_tpu_torch.models import holtwinters as hw
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import status_counts
    from spark_timeseries_tpu_torch.utils import optim

    m, horizon = entry.HW_PERIOD, 48
    n_mult = min(100_000, rows)
    log(f"phase 6: hourly path on {rows} x {t}: EWMA (SES) and Holt-Winters "
        f"(period {m}) fit + {horizon}-step forecast")
    t0 = time.perf_counter()
    y = entry.gen_hourly_panel(rows, t, seed=0, device=device)
    torch.cuda.synchronize()
    log(f"  panel built on the card in {time.perf_counter() - t0:.3f} s; "
        f"NaN share {float(torch.isnan(y).float().mean()):.4f}")
    torch.cuda.reset_peak_memory_stats()
    walls, stage_launches, stage_reads, stage_loops = {}, {}, {}, {}
    # the optimizer's lockstep loops, as (rows, first iteration): a second
    # loop over the straggler cap shows that compaction engaged
    loops = []
    real_run = optim._run

    def spy_run(fb, state, k, *args):
        loops.append((int(state.x.shape[0]), k))
        return real_run(fb, state, k, *args)

    def timed(name, fn):
        before, reads = dict(ck.LAUNCHES), optim.host_reads.count
        n_loops = len(loops)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        stage_launches[name] = {k: v - before[k] for k, v in
                                ck.LAUNCHES.items() if v > before[k]}
        stage_reads[name] = optim.host_reads.count - reads
        stage_loops[name] = loops[n_loops:]
        return out

    ck.reset_launch_counts()
    optim.host_reads.count = 0
    optim._run = spy_run
    try:
        es = timed("ewma_fit", lambda: ewma.fit(y, device=device))
        efc = timed("ewma_forecast", lambda: ewma.forecast(
            es.params, y, horizon, device=device))
        hs = timed("hw_fit", lambda: hw.fit(y, m, "additive", device=device))
        hfc = timed("hw_forecast", lambda: hw.forecast(
            hs.params, y, m, horizon, device=device))
        hm = timed("hw_mult_fit", lambda: hw.fit(
            y[:n_mult], m, "multiplicative", device=device))
    finally:
        optim._run = real_run
    launches = dict(ck.LAUNCHES)

    log("  walls (s): " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        "GiB")
    log(f"  kernel launches on the hourly path {launches}; by stage "
        f"{stage_launches}; optimizer host reads by stage {stage_reads}")
    log(f"  optimizer loops (rows, first iteration) by stage {stage_loops}")
    for name in ("ewma_fwd", "ewma_bwd", "hw_fwd", "hw_bwd"):
        chk.require(launches[name] > 0,
                    f"{name} launched on the hourly path ({launches[name]})")
    for stage, names in (("ewma_fit", ("ewma_fwd", "ewma_bwd")),
                         ("ewma_forecast", ("ewma_fwd",)),
                         ("hw_fit", ("hw_fwd", "hw_bwd")),
                         ("hw_mult_fit", ("hw_fwd", "hw_bwd"))):
        chk.require(all(stage_launches[stage].get(n, 0) > 0 for n in names),
                    f"{stage} went through {', '.join(names)}")
    for name, res, shape in (("ewma.fit", es, (rows, 1)),
                             ("holtwinters.fit add.", hs, (rows, 3)),
                             ("holtwinters.fit mult.", hm, (n_mult, 3))):
        conv = float(res.converged.float().mean())
        med = res.params.nanmedian(dim=0).values.tolist()
        log(f"  {name}: status {status_counts(res.status.cpu().numpy())}; "
            f"converged share {conv:.4f}; iterations max "
            f"{int(res.iters.max())}; median params {med}")
        chk.require(tuple(res.params.shape) == shape,
                    f"{name} params {list(shape)}")
        chk.require(conv > 0.9, f"{name} converged share {conv:.4f} > 0.9")
    # SES on this strongly seasonal panel follows the last value: alpha
    # near 1 for most rows (the interior case is held below)
    alpha_in = float((es.params[:, 0] < 0.99).float().mean())
    log(f"  ewma.fit: share of rows with alpha < 0.99: {alpha_in:.4f}")
    # SES: a flat forecast at the last level, finite wherever the fit is
    good = torch.isfinite(es.params).all(1)
    chk.require(tuple(efc.shape) == (rows, horizon)
                and bool(torch.isfinite(efc[good]).all())
                and bool((efc[:, 0] == efc[:, -1])[good].all()),
                "EWMA forecast [B, 48], flat and finite wherever the fit is")
    # Holt-Winters additive: the generating parameters, a finite forecast
    a, b_, g = entry.HW_PARAMS
    med = hs.params.nanmedian(dim=0).values.tolist()
    log(f"  additive median [alpha, beta, gamma] = {med} (panel made with "
        f"{list(entry.HW_PARAMS)})")
    chk.require(abs(med[0] - a) < 0.05 and abs(med[2] - g) < 0.05,
                "additive median alpha, gamma within 0.05 of the generating "
                "values")
    good = torch.isfinite(hs.params).all(1)
    chk.require(tuple(hfc.shape) == (rows, horizon)
                and bool(torch.isfinite(hfc[good]).all()),
                "Holt-Winters forecast [B, 48], finite wherever the fit is")
    # the forecast's daily profile follows the series' last day
    day = torch.nan_to_num(y[:, -m:] - y[:, -m:].mean(1, keepdim=True))
    prof = hfc[:, :m] - hfc[:, :m].mean(1, keepdim=True)
    corr = float(torch.nn.functional.cosine_similarity(
        day[good], prof[good], dim=1).median())
    log(f"  forecast vs last day's profile: median cosine {corr:.4f}")
    chk.require(corr > 0.9, "forecast keeps the daily profile (cosine > 0.9)")

    # the kernel path against the eager path on slices
    n_a, n_m = min(2048, rows), min(1024, rows)
    ys = y[:n_a].contiguous()
    for name, fit, n in (
            ("ewma.fit", lambda yv, be: ewma.fit(yv, backend=be,
                                                 device=device), n_a),
            ("holtwinters.fit add.", lambda yv, be: hw.fit(
                yv, m, "additive", backend=be, device=device), n_a),
            # one seeded start: the eager fit runs ~70k small launches a
            # gradient, and the three-start selection is the main path's
            ("holtwinters.fit mult., 1 start", lambda yv, be: hw.fit(
                yv, m, "multiplicative", backend=be, n_starts=1,
                device=device), n_m)):
        t0 = time.perf_counter()
        r_cuda = fit(ys[:n], "cuda")
        t1 = time.perf_counter()
        r_eager = fit(ys[:n], "eager")
        t2 = time.perf_counter()
        dconv, med_dp = _parity(r_cuda, r_eager)
        log(f"  {name} cuda vs eager on {n} rows ({t1 - t0:.2f} s vs "
            f"{t2 - t1:.2f} s): converged share differs by {dconv:.4f}, "
            f"median |param diff| {med_dp:.2e}")
        chk.require(dconv < 0.02 and med_dp < 1e-2,
                    f"{name} cuda vs eager within slice 1's parity bar")
    # SES where its optimum is interior: a local-level panel (random-walk
    # level plus noise, signal-to-noise q = 0.25), whose one-step-optimal
    # alpha is the steady Kalman gain (sqrt(q^2 + 4q) - q) / 2 = 0.390
    yl, a_star = _local_level_rows(n_a, t, seed=3, device=device)
    r_cuda = ewma.fit(yl, backend="cuda", device=device)
    r_eager = ewma.fit(yl, backend="eager", device=device)
    dconv, med_dp = _parity(r_cuda, r_eager)
    for be, r in (("cuda", r_cuda), ("eager", r_eager)):
        a_fit = r.params[:, 0]
        inside = float(((a_fit > 0.05) & (a_fit < 0.95)).float().mean())
        med = float(a_fit.nanmedian())
        log(f"  ewma.fit ({be}) on a {n_a}-row local-level panel: median "
            f"alpha {med:.4f} (optimum {a_star:.4f}), share in (0.05, 0.95) "
            f"{inside:.4f}, converged {float(r.converged.float().mean()):.4f}")
        chk.require(abs(med - a_star) < 0.05 and inside > 0.9,
                    f"ewma.fit ({be}) finds the interior SES optimum")
    log(f"  ewma.fit cuda vs eager there: converged share differs by "
        f"{dconv:.4f}, median |param diff| {med_dp:.2e}")
    chk.require(dconv < 0.02 and med_dp < 1e-2,
                "ewma.fit interior optimum cuda vs eager within slice 1's "
                "parity bar")
    del yl
    f_eager = ewma.forecast(es.params[:n_a], ys, horizon, backend="eager",
                            device=device)
    err, rel = rel_err(efc[:n_a], f_eager)
    log(f"  EWMA forecast cuda vs eager on {n_a} rows: max_abs={err:.3e}")
    chk.require(rel <= 1e-5, "EWMA forecast cuda vs eager within 1e-5")
    f_cpu = hw.forecast(hs.params[:n_a].cpu(), ys.cpu(), m, horizon,
                        device="cpu")
    err, rel = rel_err(hfc[:n_a].cpu(), f_cpu)
    log(f"  Holt-Winters forecast card vs host on {n_a} rows: "
        f"max_abs={err:.3e}")
    chk.require(rel <= 1e-5, "Holt-Winters forecast card vs host within 1e-5")
    del ys, es, efc, hfc, hm
    profile_fit(lambda: hw.fit(y, m, "additive", device=device),
                "additive Holt-Winters fit")
    return {"launches": launches, "walls": walls, "rows": rows, "time": t,
            "n_mult": n_mult}


def phase_timing_hourly(chk: Checks, hourly: dict, device) -> dict:
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import base
    from spark_timeseries_tpu_torch.ops import _build
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout

    rows, t, m = hourly["rows"], hourly["time"], entry.HW_PERIOD
    n_mult = hourly["n_mult"]
    log(f"phase 7: smoothing kernels at the hourly path's shape [T, B] = "
        f"[{t}, {rows}]: every variant the path runs against its plain "
        "version, then times")
    torch.cuda.reset_peak_memory_stats()
    ya, nv = base.maybe_align(
        entry.gen_hourly_panel(rows, t, seed=1, device=device), "no-trailing")
    B, n_el, f = rows, t * rows, 4
    gen = torch.Generator(device=device)
    gen.manual_seed(t)
    gbar = torch.full((B,), 1.0 / t, device=device)
    out = {}
    # EWMA, every mode the path runs: sum (line-search trials), both
    # (gradient evaluations), e (the forecast); the adjoint with the
    # per-series cotangent (the fit's gradient)
    xt, zb = ck.ewma_prefold(ya, nv)
    alpha = 0.05 + 0.9 * torch.rand(B, generator=gen, device=device)
    s_ref, sse_ref = ck.ewma_fwd_plain(xt, alpha, zb, "both")
    s = ck.ewma_fwd(xt, alpha, zb, "e")
    chk.compare("ewma_fwd", "mode e, hourly shape", s, s_ref)
    sse = ck.ewma_fwd(xt, alpha, zb, "sum")
    chk.compare("ewma_fwd", "mode sum, hourly shape", sse, sse_ref)
    s_both, sse_both = ck.ewma_fwd(xt, alpha, zb, "both")
    chk.compare("ewma_fwd", "mode both (smoothed), hourly shape", s_both,
                s_ref)
    chk.compare("ewma_fwd", "mode both (sum), hourly shape", sse_both,
                sse_ref)
    chk.require(torch.equal(sse_both, sse),
                "ewma_fwd sum == both bitwise, hourly shape")
    del s_ref, s_both
    chk.compare("ewma_bwd", "galpha, per-series, hourly shape",
                ck.ewma_bwd(xt, s, alpha, zb, gbar)[0],
                ck.ewma_bwd_plain(xt, s, alpha, zb, gbar)[0])
    # forward sum: reads x, alpha, zb, writes the SSE; 6 flops an element
    ms = cuda_ms(lambda: ck.ewma_fwd(xt, alpha, zb, "sum"))
    plain = cuda_ms(lambda: ck.ewma_fwd_plain(xt, alpha, zb, "sum"), reps=1)
    out["ewma_fwd"] = (ms, plain, *_bound(f * (n_el + 3 * B), 6 * n_el))
    log("  ewma_fwd mode both: "
        f"{cuda_ms(lambda: ck.ewma_fwd(xt, alpha, zb, 'both')):.3f} ms "
        f"(bound {_bound(f * (2 * n_el + 3 * B), 6 * n_el)[0]:.3f} ms)")
    # adjoint, per-series cotangent: reads x and s, alpha, zb, g, writes
    # galpha; ~12 flops an element
    ms = cuda_ms(lambda: ck.ewma_bwd(xt, s, alpha, zb, gbar))
    plain = cuda_ms(lambda: ck.ewma_bwd_plain(xt, s, alpha, zb, gbar), reps=1)
    out["ewma_bwd"] = (ms, plain, *_bound(f * (2 * n_el + 4 * B), 12 * n_el))
    log("  ewma_bwd with the data's cotangent: "
        f"{cuda_ms(lambda: ck.ewma_bwd(xt, s, alpha, zb, gbar, True)):.3f} "
        f"ms (bound {_bound(f * (3 * n_el + 4 * B), 14 * n_el)[0]:.3f} ms)")
    del xt, s
    # Holt-Winters at the generating parameters: the additive model on the
    # whole panel, the multiplicative one on the rows its fit takes, and
    # the global-ring route through a period with no register instantiation
    m_glob = 25
    seeds = ck.hw_seeds(ya, m, False, nv)
    seeds_mult = ck.hw_seeds(ya[:n_mult], m, True, nv[:n_mult])
    seeds_glob = ck.hw_seeds(ya, m_glob, False, nv)
    l0, t0, _, zbh = seeds
    yt = layout.time_major(ya)
    del ya
    params = torch.tensor(entry.HW_PARAMS, device=device).repeat(B, 1)
    hold_hw(chk, yt, params, seeds, m, False, gen, "add., hourly shape")
    yt_mult = yt[:, :n_mult].contiguous()
    hold_hw(chk, yt_mult, params[:n_mult], seeds_mult, m, True, gen,
            f"mult., hourly shape on {n_mult} rows")
    walked = torch.zeros(n_mult, dtype=torch.int32, device=device)
    _hw_lib_fwd(_build.load("hw"), yt_mult, params[:n_mult], seeds_mult, m,
                True, False, walked)()
    log(f"  hw_fwd multiplicative on the hourly panel's {n_mult} rows: "
        f"{int(walked.sum())} rows walked again with __fdiv_rn (outside the "
        "fast divide's range)")
    chk.require(not ck.hw_ring_in_registers(m_glob),
                f"period {m_glob} takes the global-ring route")
    chk.compare("hw_fwd", f"sse, m={m_glob} global ring, hourly shape",
                ck.hw_fwd(yt, params, *seeds_glob, m_glob, False),
                ck.hw_fwd_plain(yt, params, *seeds_glob, m_glob, False))
    # forward sum: reads y, params, l0, t0, zb and the seed ring, writes the
    # SSE; ~14 flops an element (additive)
    ms = cuda_ms(lambda: ck.hw_fwd(yt, params, *seeds, m, False))
    plain = cuda_ms(lambda: ck.hw_fwd_plain(yt, params, *seeds, m, False),
                    reps=1)
    out["hw_fwd"] = (ms, plain, *_bound(f * (n_el + (7 + m) * B), 14 * n_el))
    # save_resid writes e, L, T and S_old; the adjoint could form e from
    # the other three (the 4-panel bounds)
    ms_save = cuda_ms(lambda: ck.hw_fwd(yt, params, *seeds, m, False, True))
    log(f"  hw_fwd save_resid: {ms_save:.3f} ms (bound "
        f"{_bound(f * (5 * n_el + (7 + m) * B), 14 * n_el)[0]:.3f} ms; "
        f"without e {_bound(f * (4 * n_el + (7 + m) * B), 14 * n_el)[0]:.3f}"
        " ms)")
    ms_mult = cuda_ms(lambda: ck.hw_fwd(yt_mult, params[:n_mult],
                                        *seeds_mult, m, True))
    n_mel = t * n_mult
    bound_mult = _bound(f * (n_mel + (7 + m) * n_mult), 16 * n_mel)
    log(f"  hw_fwd sum, multiplicative on {n_mult} rows: {ms_mult:.3f} ms "
        f"(bound {bound_mult[0]:.3f} ms ({bound_mult[1]}), "
        f"{100 * bound_mult[0] / ms_mult:.1f} % of it)")
    log(f"  hw_fwd sum, global-ring route (m={m_glob}): "
        f"{cuda_ms(lambda: ck.hw_fwd(yt, params, *seeds_glob, m_glob, False)):.3f}"
        " ms")
    # the multiplicative adjoint on the same rows, per-series cotangent:
    # reads y, L, T, S_old and e, writes 3 sums; ~45 flops an element
    # (three quotients)
    e_m, lv_m, tr_m, so_m, _ = ck.hw_fwd(yt_mult, params[:n_mult],
                                         *seeds_mult, m, True, True)
    l0m, t0m, _, zbm = seeds_mult
    gbar_m = gbar[:n_mult].contiguous()
    ms_bm = cuda_ms(lambda: ck.hw_bwd(yt_mult, params[:n_mult], l0m, t0m,
                                      zbm, lv_m, tr_m, so_m, e_m, gbar_m, m,
                                      True))
    bound_bm = _bound(f * (5 * n_mel + 10 * n_mult), 45 * n_mel)
    log(f"  hw_bwd multiplicative on {n_mult} rows: {ms_bm:.3f} ms (bound "
        f"{bound_bm[0]:.3f} ms ({bound_bm[1]}), "
        f"{100 * bound_bm[0] / ms_bm:.1f} % of it)")
    del e_m, lv_m, tr_m, so_m
    del yt_mult, seeds_mult, seeds_glob
    e, lv, tr, so, _ = ck.hw_fwd(yt, params, *seeds, m, False, True)
    # adjoint, per-series cotangent: reads y, L, T, S_old and e, the
    # parameters and l0, t0, zb, g, writes 3 sums; ~30 flops an element
    ms = cuda_ms(lambda: ck.hw_bwd(yt, params, l0, t0, zbh, lv, tr, so, e,
                                   gbar, m, False))
    plain = cuda_ms(lambda: ck.hw_bwd_plain(yt, params, l0, t0, zbh, lv, tr,
                                            so, e, gbar, m, False), reps=1)
    out["hw_bwd"] = (ms, plain, *_bound(f * (5 * n_el + 10 * B), 30 * n_el))
    log(f"  hw_bwd bound without reading e: "
        f"{_bound(f * (4 * n_el + 10 * B), 30 * n_el)[0]:.3f} ms; peak memory "
        f"of this phase {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, (ms, plain, bms, by) in out.items():
        log(f"  {name:10s} {ms:9.3f} ms  plain {plain:10.3f} ms  bound "
            f"{bms:.3f} ms ({by})  library: none (no single PyTorch call "
            "computes this function)")
    return out


def _bound(nbytes, flops):
    """(least ms for the work, what bounds it): bytes over the memory rate
    or flops over the float32 rate, whichever is larger."""
    tb, to = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def phase_timing(chk: Checks, main: dict, device) -> dict:
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    rows, t = main["rows"], main["time"]
    p, q, k = 1, 1, 3
    log(f"phase 7: kernel times at the ARIMA path's shape [T, B] = "
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

    bound = _bound
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


SEASON = 24  # the hourly panel's period
AIRLINE = ((0, 1, 1), (0, 1, 1, SEASON))  # the airline model
# the order search's grids: the headline panel's plain group and the
# hourly panel's seasonal group
GRID_PLAIN = (((1, 1, 0), None), ((0, 1, 1), None), ((1, 1, 1), None),
              ((2, 1, 2), None))
GRID_SEASONAL = (((0, 1, 1), (0, 1, 1, SEASON)),
                 ((1, 1, 0), (1, 1, 0, SEASON)),
                 ((1, 1, 1), (1, 1, 1, SEASON)))
GRID_SEASONAL_ROWS = 100_000
# (label, order, seasonal, rows, listings) of the CSS kernels' seasonal
# checks, run with the order's structural support (the lag route) and with
# every lag listed (the lag route up to 32 lags a side, else the local
# route): the airline model (q_full = 25), (1,0,1)(1,1,1,24) (p_full =
# q_full = 25), s = 7 and 52; and s = 168 with its support only, whose
# rings do not fit a block's shared memory (the local route; with every lag
# listed its plain version alone would take most of a minute)
LAG_CASES = (("airline (0,1,1)(0,1,1,24)", *AIRLINE, 65_537, 2),
             ("(1,0,1)(1,1,1,24)", (1, 0, 1), (1, 1, 1, SEASON), 65_537, 2),
             ("(2,0,2)(2,0,2,7)", (2, 0, 2), (2, 0, 2, 7), 16_385, 2),
             ("(1,0,1)(1,1,1,52)", (1, 0, 1), (1, 1, 1, 52), 16_385, 2),
             ("(1,0,1)(1,0,1,168)", (1, 0, 1), (1, 0, 1, 168), 4_097, 1))


def _expanded_rows(b: int, order, seasonal, gen, device):
    """CSS kernel rows ``[c, phi_full, theta_full]`` of a seasonal model
    with parameters drawn in (-a, a), a = 0.8 / the largest of p, q, P, Q
    (c in (-a/8, a/8)), expanded as the seasonal fit expands them: each
    factor polynomial then has coefficients whose magnitudes sum below 1,
    so the MA side is invertible and the errors stay finite over T."""
    from spark_timeseries_tpu_torch.models import arima

    k = arima._n_params_seasonal(order, seasonal, True)
    a = 0.8 / max(order[0], order[2], seasonal[0], seasonal[2], 1)
    par = 2 * a * torch.rand(b, k, generator=gen, device=device) - a
    par[:, 0] *= 0.125
    return arima._sarima_kernel_params(par, order, seasonal, True)


def phase_kernels_seasonal(chk: Checks, device, t: int = 935) -> None:
    """Phase 3, the seasonal fits' routes: css_fwd in every mode and css_bwd
    with both cotangents (and the data cotangent) on css.cu's lag and local
    routes, against their plain versions with the same lags, with expanded
    seasonal coefficients; the unlisted gradient columns exactly 0 and
    every launch on the route ``ck.css_route`` names."""
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    gen = torch.Generator(device=device)
    gen.manual_seed(24)
    routes = set()
    for label, order, seasonal, b, listings in LAG_CASES:
        p, q, _ = arima.seasonal_lag_span(order, seasonal)
        support = arima._lag_support(order, seasonal)
        yt, zb, _, _ = ragged_panel(b, t, p, seed=p + q, device=device)
        params = _expanded_rows(b, order, seasonal, gen, device)
        for lags in (support, None)[:listings]:
            route = ck.css_route(p, q, lags)
            what = (f"{label}, {'support' if lags else 'every lag'} "
                    f"({route})")
            log(f"phase 3: CSS kernels, {what}, vs plain at B={b} T={t}")
            t0 = time.perf_counter()
            ck.reset_launch_counts()
            hold_css(chk, yt, params, zb, p, q, lags, what, gen)
            n_fwd, n_bwd = ck.LAUNCHES["css_fwd"], ck.LAUNCHES["css_bwd"]
            chk.require(
                ck.ROUTE_LAUNCHES["css_fwd"][route] == n_fwd > 0
                and ck.ROUTE_LAUNCHES["css_bwd"][route] == n_bwd > 0,
                f"{what}: every launch on the {route} route")
            routes.add(route)
            log(f"  ({time.perf_counter() - t0:.1f} s)")
        del yt
        torch.cuda.synchronize()
    chk.require(routes == {"lag", "local"},
                f"phase 3 held the lag and local routes ({sorted(routes)})")


def hold_css(chk: Checks, yt, params, zb, p: int, q: int, lags, what: str,
             gen) -> None:
    """css_fwd in every mode and css_bwd with both cotangents (and gy)
    against their plain versions with ``lags``; sum == both bitwise."""
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    t, b = yt.shape
    for mode in ("e", "sum", "tail"):
        chk.compare("css_fwd", f"{what}, mode {mode}",
                    ck.css_fwd(yt, params, zb, p, q, mode, lags=lags),
                    ck.css_fwd_plain(yt, params, zb, p, q, mode, lags=lags))
    e_both, s_both = ck.css_fwd(yt, params, zb, p, q, "both", lags=lags)
    chk.require(torch.equal(s_both, ck.css_fwd(yt, params, zb, p, q, "sum",
                                               lags=lags)),
                f"css_fwd {what}: sum == both bitwise")
    e = ck.css_fwd_plain(yt, params, zb, p, q, "e", lags=lags)
    chk.compare("css_fwd", f"{what}, mode both (errors)", e_both, e)
    del e_both
    unlisted = list(ck._unlisted(p, q, ck._css_lags(p, q, lags)))
    gbar = torch.rand(b, generator=gen, device=yt.device) / t
    gpan = torch.randn(t, b, generator=gen, device=yt.device)
    for g, name in ((gbar, "per-series"), (gpan, "[T, B]")):
        gp, gy = ck.css_bwd(yt, e, params, zb, g, p, q, True, lags=lags)
        gp_r, gy_r = ck.css_bwd_plain(yt, e, params, zb, g, p, q, True,
                                      lags=lags)
        chk.compare("css_bwd", f"{what}, gparams, {name}", gp, gp_r)
        chk.compare("css_bwd", f"{what}, gy, {name}", gy, gy_r)
        if unlisted:
            chk.require(not bool(gp[:, unlisted].any()),
                        f"css_bwd {what}, {name}: unlisted columns 0")
        del gp, gy, gp_r, gy_r
    del e, gpan


def _support_bound(n_el: int, rows: int, ka: int, km: int):
    """Bytes and flops of the CSS kernels' work on ``n_el`` panel elements
    of ``rows`` series with ka AR and km MA lags listed: each input read
    once and each output written once.  The forward reads y, the listed
    coefficients and zb and writes sse (and e for both); the adjoint with
    the per-series cotangent reads y only with AR lags, e (for g_t = 2 e_t
    gbar, and the MA sums), the coefficients, zb and gbar, and writes the
    listed gradient rows."""
    f, k = 4, 1 + ka + km
    fwd = f * (n_el + rows * k + 2 * rows)
    bwd = f * (n_el * ((ka > 0) + 1) + 2 * rows * k + 2 * rows)
    return {"css_fwd sum": (fwd, n_el * (2 * (ka + km) + 3)),
            "css_fwd both": (fwd + f * n_el, n_el * (2 * (ka + km) + 3)),
            "css_bwd": (bwd, n_el * (2 * (km + k) + 4))}


def phase_timing_seasonal(chk: Checks, device) -> dict:
    """Phase 7, the lag route at the airline fit's shape [935, 1M]: css_fwd
    sum and both and css_bwd with the per-series cotangent, with the
    airline model's support (MA lags 1, 24, 25) and with every lag listed,
    each against its plain version once more, timed beside its bound (the
    bytes the listed lags' work moves) and the dense-k bound (both
    panels and all 26 coefficients)."""
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck

    rows, t = HOURLY_ROWS, HOURLY_TIME - 1 - SEASON
    order, seasonal = AIRLINE
    p, q, _ = arima.seasonal_lag_span(order, seasonal)
    support = arima._lag_support(order, seasonal)
    log(f"phase 7: the lag route at the airline fit's shape [T, B] = "
        f"[{t}, {rows}] (p_full={p}, q_full={q}, support {support})")
    gen = torch.Generator(device=device)
    gen.manual_seed(25)
    yt, zb, _, _ = ragged_panel(rows, t, p, seed=26, device=device)
    params = _expanded_rows(rows, order, seasonal, gen, device)
    e = ck.css_fwd(yt, params, zb, p, q, "e", lags=support)
    gbar = torch.full((rows,), 1.0 / t, device=device)
    f, n_el, k = 4, t * rows, 1 + p + q
    out = {}
    for name, lags in (("support", support), ("every lag", None)):
        chk.compare("css_fwd", f"airline {name} mode sum, [935, 1M]",
                    ck.css_fwd(yt, params, zb, p, q, "sum", lags=lags),
                    ck.css_fwd_plain(yt, params, zb, p, q, "sum", lags=lags))
        chk.compare("css_bwd", f"airline {name} gparams, [935, 1M]",
                    ck.css_bwd(yt, e, params, zb, gbar, p, q,
                               lags=lags)[0],
                    ck.css_bwd_plain(yt, e, params, zb, gbar, p, q,
                                     lags=lags)[0])
        ka, km = (len(support[0]), len(support[1])) if lags else (p, q)
        work = _support_bound(n_el, rows, ka, km)
        cases = {
            "css_fwd sum": (
                lambda: ck.css_fwd(yt, params, zb, p, q, "sum", lags=lags),
                lambda: ck.css_fwd_plain(yt, params, zb, p, q, "sum",
                                         lags=lags)),
            "css_fwd both": (
                lambda: ck.css_fwd(yt, params, zb, p, q, "both", lags=lags),
                lambda: ck.css_fwd_plain(yt, params, zb, p, q, "both",
                                         lags=lags)),
            "css_bwd": (
                lambda: ck.css_bwd(yt, e, params, zb, gbar, p, q,
                                   lags=lags),
                lambda: ck.css_bwd_plain(yt, e, params, zb, gbar, p, q,
                                         lags=lags)),
        }
        # the dense-k bound: both panels and every coefficient, whatever
        # the listing
        dense_k = {"css_fwd sum": f * (n_el + rows * k + 2 * rows),
                   "css_fwd both": f * (2 * n_el + rows * k + 2 * rows),
                   "css_bwd": f * (2 * n_el + 2 * rows * k + 2 * rows)}
        for kern, (fn, plain_fn) in cases.items():
            ms = cuda_ms(fn)
            plain = cuda_ms(plain_fn, reps=1)
            nbytes, fl = work[kern]
            bms, by = _bound(nbytes, fl)
            old_bms, _ = _bound(dense_k[kern], fl)
            out[f"{kern}, {name}"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "share_of_bound": bms / ms, "dense_k_bound_ms": old_bms}
            log(f"  {kern:12s} {name:9s} lag {ms:8.3f} ms  plain "
                f"{plain:10.3f} ms  bound {bms:.3f} ms ({by}; "
                f"{nbytes / 1e9:.2f} GB, {fl / 1e9:.1f} GFLOP) = "
                f"{100 * bms / ms:.1f} % of it; dense-k bound "
                f"{old_bms:.3f} ms")
    del yt, e
    return out


def _grid_blocks(res, specs):
    """Per order of a fit_grid pack: (params, nll, eligible, converged,
    iters, status) columns."""
    from spark_timeseries_tpu_torch.models import arima

    infos = [arima._grid_spec_info(o, s, True) for o, s in specs]
    k_max = max(i["k"] for i in infos)
    w = k_max + arima.GRID_PACK_COLS
    return [(res.params[:, g * w:g * w + i["k"]],)
            + tuple(res.params[:, g * w + k_max + j] for j in range(5))
            for g, i in enumerate(infos)]


def _grid_report(chk: Checks, res, specs, what: str) -> None:
    from spark_timeseries_tpu_torch.reliability import status_counts

    chk.require(bool(torch.isfinite(res.params).all()),
                f"{what}: the pack is finite")
    for (o, s), (par, _, elig, conv, its, st) in zip(
            specs, _grid_blocks(res, specs)):
        med = par[conv > 0].median(dim=0).values.tolist()
        log(f"  {o}{'' if s is None else s}: status "
            f"{status_counts(st.to(torch.int8).cpu().numpy())}; eligible "
            f"{float(elig.mean()):.4f}, converged {float(conv.mean()):.4f}, "
            f"iterations max {int(its.max())}; median params "
            f"{[round(v, 4) for v in med]}")


def _route_counts(ck) -> str:
    return (f"css_fwd {ck.LAUNCHES['css_fwd']} (by route "
            f"{ck.ROUTE_LAUNCHES['css_fwd']}), css_bwd "
            f"{ck.LAUNCHES['css_bwd']} (by route "
            f"{ck.ROUTE_LAUNCHES['css_bwd']}), hr_moments "
            f"{ck.LAUNCHES['hr_moments']}")


def _launches(ck) -> dict:
    """Launch counts, the CSS kernels' by route too."""
    return {**ck.LAUNCHES, **{f"{k} {r}": n
                              for k, v in ck.ROUTE_LAUNCHES.items()
                              for r, n in v.items()}}


def _require_lag_route(chk: Checks, ck, what: str) -> None:
    """Every CSS launch since the counts were reset ran on the lag route."""
    for name in ("css_fwd", "css_bwd"):
        by = ck.ROUTE_LAUNCHES[name]
        chk.require(by["lag"] == ck.LAUNCHES[name] > 0,
                    f"{what}: {name} launched on the lag route only "
                    f"({by})")


def phase_order_search(chk: Checks, device) -> dict:
    """Phase 8a-c: the order-search path at full width on the kernels."""
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import status_counts

    out = {}
    # 8a: the fused plain grid over the headline panel
    log(f"phase 8a: arima.fit_grid of {len(GRID_PLAIN)} orders over the "
        f"{ROWS} x {TIME} headline panel, kernel route with compaction")
    y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = arima.fit_grid(y, GRID_PLAIN, backend="cuda", device=device)
    torch.cuda.synchronize()
    out["grid_s"] = time.perf_counter() - t0
    out["grid_launches"] = dict(ck.LAUNCHES)
    log(f"  wall {out['grid_s']:.3f} s; iterations max "
        f"{int(res.iters.max())}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
        f"{_route_counts(ck)}")
    for name in ("css_fwd", "css_bwd", "hr_moments"):
        n_launch = out["grid_launches"][name]
        chk.require(n_launch > 0, f"{name} launched by fit_grid ({n_launch})")
    _grid_report(chk, res, GRID_PLAIN, "fit_grid")
    profile_fit(lambda: arima.fit_grid(y, GRID_PLAIN, backend="cuda",
                                       device=device),
                f"fit_grid of {len(GRID_PLAIN)} orders")
    blk = _grid_blocks(res, GRID_PLAIN)[2]  # the (1,1,1) block
    med = blk[0][blk[3] > 0].median(dim=0).values.tolist()
    log(f"  (1,1,1) block median [c, phi, theta] = {med} (panel made with "
        "phi=0.6, theta=0.3)")
    chk.require(abs(med[1] - 0.6) < 0.05 and abs(med[2] - 0.3) < 0.05,
                "fit_grid (1,1,1) median phi, theta within 0.05")
    del res, blk
    n = min(4096, ROWS)
    ys = y[:n].contiguous()
    del y
    r_cuda = arima.fit_grid(ys, GRID_PLAIN, backend="cuda", device=device)
    t0 = time.perf_counter()
    r_eager = arima.fit_grid(ys, GRID_PLAIN, backend="eager", device=device)
    torch.cuda.synchronize()
    log(f"  eager fit_grid on {n} rows: {time.perf_counter() - t0:.1f} s")
    for (o, _), bc, be in zip(GRID_PLAIN, _grid_blocks(r_cuda, GRID_PLAIN),
                              _grid_blocks(r_eager, GRID_PLAIN)):
        both = (bc[3] > 0) & (be[3] > 0)
        dconv = abs(float(bc[3].mean()) - float(be[3].mean()))
        dpar = (bc[0][both] - be[0][both]).abs()
        med_dp = float(dpar.median()) if dpar.numel() else float("inf")
        # a row is ineligible where its nll is not finite: a start whose
        # recursion overflows float32 in one rounding of the init and not
        # in the other (the two inits are the moment kernel's and eager's)
        delig = int((bc[2] != be[2]).sum())
        log(f"  {o} cuda vs eager on {n} rows: converged share differs by "
            f"{dconv:.4f}, median |param diff| {med_dp:.2e}, eligibility "
            f"differs on {delig} rows")
        chk.require(delig <= n // 1000 and dconv < 0.02 and med_dp < 1e-2,
                    f"fit_grid {o} cuda vs eager: eligibility equal but on "
                    "0.1 % of rows at most, the reference's parity bar")
    r_fit = arima.fit(ys, (1, 1, 1), backend="cuda", device=device)
    bc = _grid_blocks(r_cuda, GRID_PLAIN)[2]
    both = (bc[3] > 0) & r_fit.converged
    dconv = abs(float(bc[3].mean()) - float(r_fit.converged.float().mean()))
    med_dp = float((bc[0][both] - r_fit.params[both]).abs().median())
    log(f"  (1,1,1) block vs arima.fit on {n} rows: converged share differs "
        f"by {dconv:.4f}, median |param diff| {med_dp:.2e}")
    chk.require(dconv < 0.02 and med_dp < 1e-2,
                "fit_grid (1,1,1) block vs arima.fit within the parity bar")
    del ys, r_cuda, r_eager, r_fit, bc

    # 8b: the airline model on the hourly panel (the lag route)
    order, seasonal = AIRLINE
    log(f"phase 8b: arima.fit(y, {order}, seasonal={seasonal}) of the "
        f"{HOURLY_ROWS} x {HOURLY_TIME} hourly panel")
    y = entry.gen_hourly_panel(HOURLY_ROWS, HOURLY_TIME, seed=0,
                               device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = arima.fit(y, order, seasonal=seasonal, device=device)
    torch.cuda.synchronize()
    out["airline_s"] = time.perf_counter() - t0
    out["airline_launches"] = _launches(ck)
    counts = status_counts(res.status.cpu().numpy())
    log(f"  wall {out['airline_s']:.3f} s; iterations max "
        f"{int(res.iters.max())}; status {counts}; converged share "
        f"{float(res.converged.float().mean()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  launches {_route_counts(ck)}")
    med = res.params[res.converged].median(dim=0).values.tolist()
    log(f"  median [c, theta, THETA] = {med}")
    _require_lag_route(chk, ck, "airline fit")
    chk.require(bool((res.status == 0).all()), "airline fit: every row OK")
    chk.require(tuple(res.params.shape) == (HOURLY_ROWS, 3)
                and float(res.converged.float().mean()) > 0.9
                and bool(torch.isfinite(res.params[res.converged]).all()),
                "airline fit: params [B, 3], converged share > 0.9, finite")
    del res
    profile_fit(lambda: arima.fit(y, order, seasonal=seasonal,
                                  device=device), "airline fit")
    n = min(2048, HOURLY_ROWS)
    ys = y[:n].contiguous()
    r_cuda = arima.fit(ys, order, seasonal=seasonal, backend="cuda",
                       device=device)
    t0 = time.perf_counter()
    r_eager = arima.fit(ys, order, seasonal=seasonal, backend="eager",
                        device=device)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    dconv, med_dp = _parity(r_cuda, r_eager)
    log(f"  airline cuda vs eager on {n} rows (eager {eager_s:.1f} s): "
        f"converged share differs by {dconv:.4f}, median |param diff| "
        f"{med_dp:.2e}")
    chk.require(torch.equal(r_cuda.status == 5, r_eager.status == 5)
                and dconv < 0.02 and med_dp < 1e-2,
                "airline fit cuda vs eager: exclusions equal, the parity bar")
    del ys, r_cuda, r_eager

    # 8c: the seasonal grid on the hourly panel's first rows (compaction
    # through the quadratic coefficient maps)
    n = min(GRID_SEASONAL_ROWS, HOURLY_ROWS)
    log(f"phase 8c: arima.fit_grid of the seasonal group on the hourly "
        f"panel's first {n} rows")
    ys = y[:n].contiguous()
    del y
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = arima.fit_grid(ys, GRID_SEASONAL, backend="cuda", device=device)
    torch.cuda.synchronize()
    out["grid_seasonal_s"] = time.perf_counter() - t0
    out["grid_seasonal_launches"] = _launches(ck)
    log(f"  wall {out['grid_seasonal_s']:.3f} s; iterations max "
        f"{int(res.iters.max())}; launches {_route_counts(ck)}")
    _require_lag_route(chk, ck, "seasonal fit_grid")
    _grid_report(chk, res, GRID_SEASONAL, "seasonal fit_grid")
    elig = torch.stack([b[2] for b in _grid_blocks(res, GRID_SEASONAL)])
    chk.require(float(elig.mean()) > 0.99,
                "seasonal fit_grid: eligible rows")
    del ys, res
    return out


def phase_leftovers(chk: Checks, params_main, device, rows: int = 100_000,
                    t: int = 1_000) -> None:
    """Phase 8d: the statistical tests, the effects transform, AR and
    Cochrane-Orcutt, and the spline fill, PACF and cross-correlation."""
    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import arima, autoregression
    from spark_timeseries_tpu_torch.models import regression_arima
    from spark_timeseries_tpu_torch.ops import univariate as uv
    from spark_timeseries_tpu_torch.stats import tests as st

    log(f"phase 8d: statistical tests on the {ROWS} x {TIME} headline panel"
        " (whole panel a call)")
    y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
    walls = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 3)
        return r

    rej = {}
    for what, x in (("levels", y), ("differences", None)):
        if x is None:
            x = y[:, 1:] - y[:, :-1]
        _, p_adf = timed(f"adf {what}", lambda: st.batch_adftest(
            x, device=device))
        _, p_kpss = timed(f"kpss {what}", lambda: st.batch_kpsstest(
            x, device=device))
        rej[what] = (float((p_adf < 0.05).float().mean()),
                     float((p_kpss < 0.05).float().mean()))
        del x, p_adf, p_kpss
    log(f"  rejection shares at 5 % (ADF, KPSS): {rej}")
    chk.require(rej["differences"][0] > rej["levels"][0] + 0.5,
                "ADF rejects a unit root far more often on the differences")
    chk.require(rej["levels"][1] > rej["differences"][1],
                "KPSS rejects stationarity more often on the levels")
    e = timed("remove_effects", lambda: arima.remove_time_dependent_effects(
        params_main, y, (1, 1, 1), device=device))
    del y
    q, p_lb = timed("ljung-box", lambda: st.batch_lbtest(
        e[:, 1:], 10, device=device))  # the first entry is a constant
    del e
    lb_rej = float((p_lb < 0.05).float().mean())
    log(f"  Ljung-Box(10) on the ARIMA(1,1,1) innovations: median Q "
        f"{float(q.median()):.3f}, rejection share at 5 % {lb_rej:.4f}")
    chk.require(bool(torch.isfinite(q).all()) and lb_rej < 0.1,
                "Ljung-Box: the fitted model's innovations look white")
    del q, p_lb

    log(f"phase 8d: autoregression.fit and Cochrane-Orcutt on {rows} x {t}")
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    z = torch.randn(t, rows, generator=gen, device=device)
    ar = torch.empty_like(z)
    ar[0], ar[1] = z[0], z[1]
    for i in range(2, t):  # AR(2): c 0.2, phi 0.5, -0.3
        ar[i] = 0.2 + 0.5 * ar[i - 1] - 0.3 * ar[i - 2] + z[i]
    res = timed("ar_fit", lambda: autoregression.fit(ar.t(), 2,
                                                     device=device))
    med = res.params.median(dim=0).values.tolist()
    log(f"  AR(2) median [c, phi_1, phi_2] = {med} (made with 0.2, 0.5, "
        "-0.3)")
    chk.require(max(abs(a - b) for a, b in zip(med, (0.2, 0.5, -0.3)))
                < 0.02 and bool(res.converged.all()),
                "AR(2) fit within 0.02 of the generating parameters")
    X = torch.randn(rows, t, 2, generator=gen, device=device)
    u = torch.empty_like(z)
    u[0] = z[0]
    for i in range(1, t):  # AR(1) errors, rho 0.6
        u[i] = 0.6 * u[i - 1] + z[i]
    yr = 1.0 + X @ torch.tensor([2.0, -1.0], device=device) + u.t()
    del z, ar, u
    co_fit = regression_arima.fit_cochrane_orcutt
    res = timed("cochrane_orcutt", lambda: co_fit(yr, X, device=device))
    med = res.params.median(dim=0).values.tolist()
    log(f"  Cochrane-Orcutt median [beta_0, beta_1, beta_2, rho] = {med} "
        "(made with 1, 2, -1, 0.6)")
    chk.require(max(abs(a - b) for a, b in zip(med, (1.0, 2.0, -1.0, 0.6)))
                < 0.02, "Cochrane-Orcutt within 0.02 of beta and rho")
    del X, yr, res

    log(f"phase 8d: fill_spline, pacf(20), cross_corr(20) on the "
        f"{VOL_ROWS} x {VOL_TIME} volatility panel")
    prices = entry.gen_garch_prices(VOL_ROWS, VOL_TIME, seed=0, device=device)
    filled = timed("fill_spline", lambda: uv.fill_spline(prices))
    valid = ~torch.isnan(prices)
    idx = torch.arange(VOL_TIME, device=device)
    first = torch.where(valid, idx, VOL_TIME).amin(1, keepdim=True)
    last = torch.where(valid, idx, -1).amax(1, keepdim=True)
    inside = (idx >= first) & (idx <= last)
    chk.require(torch.equal(filled[valid], prices[valid])
                and bool(torch.isfinite(filled[inside]).all())
                and bool(torch.isnan(filled[~inside]).all()),
                "fill_spline keeps the data, fills every interior gap and "
                "leaves the edges NaN")
    host = uv.fill_spline(prices[:256].cpu())
    err, rel = rel_err(filled[:256].cpu(), host)
    log(f"  fill_spline card vs host on 256 rows: max_abs={err:.3e}")
    chk.require(rel <= 1e-5, "fill_spline card vs host within 1e-5")
    r = 100.0 * (filled[:, 1:] - filled[:, :-1])
    del prices, filled
    pac = timed("pacf", lambda: uv.pacf(r, 20))
    xc = timed("cross_corr", lambda: uv.cross_corr(r, r * r, 20))
    fin = float(torch.isfinite(pac).all(1).float().mean())
    log(f"  pacf [B, 20]: finite rows {fin:.4f}, median |pacf| "
        f"{float(pac[torch.isfinite(pac)].abs().median()):.4f}; cross_corr "
        f"[B, 41] of r with r^2, median at lag 0 "
        f"{float(xc[:, 20].nanmedian()):.4f}")
    chk.require(tuple(pac.shape) == (VOL_ROWS, 20)
                and tuple(xc.shape) == (VOL_ROWS, 41) and fin > 0.99
                and float(pac[torch.isfinite(pac)].abs().median()) < 0.05,
                "pacf of the returns near 0, shapes [B, 20] and [B, 41]")
    log(f"  walls (s): {walls}")


# the resilient fit path's panel faults (shares of ROWS) and failing rows
FAULT_SHARES = {"nan": 0.01, "inf": 0.001, "constant": 0.0005,
                "all_nan": 0.0005}
FAIL_BUDGETS = (1, 2, 99)  # failing_fit n_failures: RETRIED, FALLBACK,
FAIL_ROWS = 8              # DIVERGED, 8 rows each
OBS_DIR = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_obs"


def _host_fit(res) -> dict:
    return {f: getattr(res, f).cpu().numpy()
            for f in ("params", "neg_log_likelihood", "converged", "iters")}


def _same_fit(a: dict, b) -> bool:
    """Every field of two fits the same bits (NaNs at the same places)."""
    import numpy as np

    return all(np.array_equal(a[f], np.asarray(getattr(b, f)),
                              equal_nan=a[f].dtype.kind == "f")
               for f in a)


def _fault_rows(yf, gen_rows):
    """Disjoint seeded row sets for each fault, then FAIL_ROWS rows for
    each failing budget among the untouched rows whose last value is
    unique in the whole panel (failing_fit finds its rows by that value)."""
    import numpy as np

    sizes = {k: int(round(v * ROWS)) for k, v in FAULT_SHARES.items()}
    sets, at = {}, 0
    for k, n in sizes.items():
        sets[k] = np.sort(gen_rows[at:at + n])
        at += n
    _, inv, counts = np.unique(yf[:, -1].cpu().numpy(), return_inverse=True,
                               return_counts=True)
    unique = counts[inv] == 1
    pool = [r for r in gen_rows[at:at + 1000] if unique[r]]
    fail = {n: np.array(pool[i * FAIL_ROWS:(i + 1) * FAIL_ROWS])
            for i, n in enumerate(FAIL_BUDGETS)}
    return sets, fail


def phase_resilient(chk: Checks, device, n_built: int) -> dict:
    """Phase 9: the resilient fit path (sanitize -> fit -> retry ladder)
    at full width with the telemetry plane on."""
    import numpy as np

    from spark_timeseries_tpu_torch import entry, obs
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.obs import promsink
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import (FitStatus,
                                                        default_ladder,
                                                        faultinject as fi,
                                                        resilient_fit,
                                                        sanitize)
    from spark_timeseries_tpu_torch.utils import compile_cache

    log(f"phase 9: resilient fit path, ARIMA(1,1,1) on {ROWS} x {TIME} "
        "with the telemetry plane on")
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    events, prom = OBS_DIR / "events.jsonl", OBS_DIR / "metrics.prom"
    for p in (events, prom):
        p.unlink(missing_ok=True)
    y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
    torch.cuda.synchronize()
    obs.enable(str(events))
    out = {"walls_s": {}}
    walls = out["walls_s"]

    # (a) a clean panel: the primary fit is the plain fit, bit for bit;
    # the two walls in turns (plain, resilient, resilient, plain)
    # where the resilient fit's extra time goes: the plain fit's host read
    # of its four result fields timed apart; the resilient fit's sanitize
    # and primary spans (fit + the same read), and what is left (masks,
    # status, meta on the host)
    fits, turns = {}, {"plain": [], "resilient": []}
    parts = {"plain read": [], "sanitize": [], "primary": [], "rest": []}
    for kind in ("plain", "resilient", "resilient", "plain"):
        t0 = time.perf_counter()
        if kind == "plain":
            r = arima.fit(y, entry.ORDER, device=device)
            torch.cuda.synchronize()
            turns[kind].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fits.setdefault(kind, _host_fit(r))
            parts["plain read"].append(time.perf_counter() - t0)
            continue
        r = resilient_fit(arima.fit, y, order=entry.ORDER, device=device)
        turns[kind].append(time.perf_counter() - t0)
        fits.setdefault(kind, r)
        hist = obs.snapshot()["histograms"]
        parts["sanitize"].append(hist["span.sanitize"]["last"])
        parts["primary"].append(hist["span.fit.primary"]["last"])
        parts["rest"].append(turns[kind][-1] - parts["sanitize"][-1]
                             - parts["primary"][-1])
    walls["plain fit, clean"] = turns["plain"]
    walls["resilient fit, clean"] = turns["resilient"]
    walls["clean parts"] = parts
    plain, rc = fits["plain"], fits["resilient"]
    log(f"  clean panel, in turns: plain fit {turns['plain']} s (then its "
        f"host read {parts['plain read']} s), resilient fit "
        f"{turns['resilient']} s = sanitize {parts['sanitize']} + primary "
        f"(fit and host read) {parts['primary']} + rest {parts['rest']} s; "
        f"status {rc.meta['status_counts']}")
    chk.require(_same_fit(plain, rc) and rc.meta["ladder"] == []
                and rc.meta["sanitize"]["rows_sanitized"] == 0,
                "clean panel: resilient_fit == arima.fit bit for bit")
    del plain, rc, fits, r

    # (b) a panel with seeded data faults and failing rows
    gen_rows = np.random.default_rng(9).permutation(ROWS)
    t0 = time.perf_counter()
    sets, fail = _fault_rows(y, gen_rows)
    yf = fi.inject_nan_rows(y, sets["nan"], seed=1)
    del y
    yf = fi.inject_inf_rows(yf, sets["inf"], seed=2)
    yf = fi.make_constant_rows(yf, sets["constant"])
    yf = fi.make_all_nan_rows(yf, sets["all_nan"])
    tails = yf[:, -1].cpu().numpy()
    designated = np.concatenate(list(fail.values()))
    chk.require(designated.size == FAIL_ROWS * len(FAIL_BUDGETS)
                and all(int((tails == tails[r]).sum()) == 1
                        for r in designated),
                f"{designated.size} failing rows, each with a last value "
                "unique in the whole panel")
    calls = []

    def allocator():  # cudaMalloc calls and cache-flushing retries so far
        st = torch.cuda.memory_stats()
        return st["segment.all.allocated"], st["num_alloc_retries"]

    def counted(yb, **kw):  # launches of each fit call the ladder makes
        before, mem0, t0 = _launches(ck), allocator(), time.perf_counter()
        res = arima.fit(yb, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after, mem1 = _launches(ck), allocator()
        calls.append({"rows": int(yb.shape[0]),
                      "backend": kw.get("backend", "auto"), "wall_s": wall,
                      "cuda_mallocs": mem1[0] - mem0[0],
                      "alloc_retries": mem1[1] - mem0[1],
                      "launches": {k: after[k] - before[k] for k in after
                                   if after[k] > before[k]}})
        return res

    counted = functools.wraps(arima.fit)(counted)

    def failing():
        fit = counted
        for n, rows in fail.items():
            fit = fi.failing_fit(fit, yf, rows, n_failures=n)
        return fit

    fit = failing()
    torch.cuda.synchronize()
    walls["faults injected"] = time.perf_counter() - t0
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    res = resilient_fit(fit, yf, order=entry.ORDER, device=device)
    walls["resilient fit, faulted"] = time.perf_counter() - t0
    launches = dict(ck.LAUNCHES)
    hist = obs.snapshot()["histograms"]
    for name in ("sanitize", "fit.primary", "fit.rung.retry",
                 "fit.rung.fallback"):
        walls[f"span {name}"] = (hist.get(f"span.{name}") or {}).get("last")
    out["calls"], out["ladder"] = list(calls), res.meta["ladder"]
    out["status_counts"] = counts = res.meta["status_counts"]
    log(f"  faulted panel: resilient fit {walls['resilient fit, faulted']:.3f}"
        f" s; spans (s) sanitize {walls['span sanitize']}, primary "
        f"{walls['span fit.primary']}, retry {walls['span fit.rung.retry']}"
        f", fallback {walls['span fit.rung.fallback']}; status {counts}")
    log(f"  sanitize meta {res.meta['sanitize']}")
    for c, rung in zip(calls, ("primary", "retry", "fallback")):
        log(f"  {rung}: {c['rows']} rows, backend {c['backend']}, fit "
            f"{c['wall_s']:.4f} s, {c['cuda_mallocs']} cudaMalloc, "
            f"{c['alloc_retries']} allocator retries, launches "
            f"{c['launches']}")
    n_san = len(sets["nan"]) + len(sets["inf"])
    n_exc = len(sets["constant"]) + len(sets["all_nan"])
    want = {"OK": ROWS - n_san - n_exc - 3 * FAIL_ROWS, "SANITIZED": n_san,
            "RETRIED": FAIL_ROWS, "FALLBACK": FAIL_ROWS,
            "DIVERGED": FAIL_ROWS, "EXCLUDED": n_exc, "TIMEOUT": 0}
    chk.require(counts == want, f"status counts exactly {want}")
    want_rows = np.zeros(ROWS, np.int8)
    want_rows[np.concatenate([sets["nan"], sets["inf"]])] = (
        FitStatus.SANITIZED)
    want_rows[np.concatenate([sets["constant"], sets["all_nan"]])] = (
        FitStatus.EXCLUDED)
    for n, status in zip(FAIL_BUDGETS, (FitStatus.RETRIED,
                                        FitStatus.FALLBACK,
                                        FitStatus.DIVERGED)):
        want_rows[fail[n]] = status
    chk.require(np.array_equal(res.status, want_rows),
                "every row's status is its fault's")
    usable = ~np.isin(res.status, [FitStatus.EXCLUDED, FitStatus.DIVERGED])
    chk.require(bool(np.isfinite(res.params[usable]).all())
                and bool(np.isnan(res.params[~usable]).all()),
                "finite params on every row but EXCLUDED / DIVERGED")
    chk.require(len(calls) == 3 and [c["rows"] for c in calls]
                == [ROWS, 32, 16], "three fit calls: the panel, then 32 "
                "and 16 padded rows")
    for c, rung in zip(calls, ("primary", "retry", "fallback")):
        la = c["launches"]
        chk.require(all(la.get(k, 0) > 0
                        and la.get(f"{k} register", 0) == la[k]
                        for k in ("css_fwd", "css_bwd")),
                    f"{rung} rung: CSS kernels on the register route ({la})")
    chk.require(calls[0]["launches"].get("hr_moments", 0) > 0,
                "primary rung: hr_moments launched (the init)")
    chk.require(all(c["launches"].get("hr_moments", 0) == 0
                    for c in calls[1:]),
                "retry and fallback rungs start from the perturbed init "
                "(no HR sweep)")
    chk.require(calls[2]["backend"] == "auto",
                "fallback rung on the 'auto' backend (the kernels)")
    out["launches"] = {k: v for k, v in launches.items() if v}

    # the same faulted fit again, fresh failure budgets: the first call's
    # primary fit against a warm one, with the allocator's events
    calls.clear()
    t0 = time.perf_counter()
    again = resilient_fit(failing(), yf, order=entry.ORDER, device=device)
    walls["resilient fit, faulted, again"] = time.perf_counter() - t0
    out["calls_again"] = list(calls)
    log(f"  faulted panel again: resilient fit "
        f"{walls['resilient fit, faulted, again']:.3f} s; fits "
        + ", ".join(f"{c['rows']} rows {c['wall_s']:.4f} s "
                    f"({c['cuda_mallocs']} cudaMalloc, {c['alloc_retries']} "
                    "retries)" for c in calls))
    chk.require(np.array_equal(again.status, res.status)
                and _same_fit({f: getattr(res, f) for f in
                               ("params", "neg_log_likelihood", "converged",
                                "iters")}, again),
                "the faulted fit again: the same statuses and bits")
    del again

    # OK rows against a plain fit of the sanitized panel
    t0 = time.perf_counter()
    clean = sanitize(yf).values
    ref = arima.fit(clean, entry.ORDER, device=device)
    torch.cuda.synchronize()
    walls["sanitize + plain fit, faulted"] = time.perf_counter() - t0
    ok = res.status == FitStatus.OK
    rp = ref.params.cpu().numpy()
    diff = np.abs(res.params[ok] - rp[ok])
    med = float(np.median(diff))
    dconv = abs(float(res.converged[ok].mean())
                - float(ref.converged.cpu().numpy()[ok].mean()))
    bitwise = {f: bool(np.array_equal(
        getattr(res, f)[ok], getattr(ref, f).cpu().numpy()[ok]))
        for f in ("params", "neg_log_likelihood", "converged", "iters")}
    log(f"  OK rows vs a plain fit of the sanitized panel: converged share "
        f"differs by {dconv:.4f}, median |param diff| {med:.2e}, max "
        f"{float(diff.max()):.2e}, the same bits {bitwise}")
    # the primary rung IS a plain fit of the sanitized panel, and the
    # ladder scatters into the other rows only
    chk.require(all(bitwise.values()),
                "OK rows: a plain fit of the sanitized panel, bit for bit")
    out["ok_rows_bitwise"] = bitwise
    del clean, ref

    # telemetry: the textfile, the stream, the memory probe
    pm = obs.peak_memory()
    summary = obs.summary()
    obs.PromTextfileSink(str(prom)).write()
    errs = promsink.validate_textfile(str(prom), obs.snapshot())
    chk.require(errs == [], f"prom textfile valid ({errs[:3]})")
    chk.require(pm.source == "device",
                f"peak_memory source {pm.source!r}, {pm.bytes} bytes")
    out["peak_memory_gib"] = pm.bytes / 2**30
    counters = summary["counters"]
    log(f"  counters {counters}")
    obs.disable()
    rep = subprocess.run(
        [sys.executable, str(Path(__file__).resolve().parent / "tools"
                             / "obs_report.py"), str(events), "--check"],
        capture_output=True, text=True, timeout=120)
    log(f"  obs_report --check: rc {rep.returncode} "
        f"{rep.stdout.strip()} {rep.stderr.strip()[:300]}")
    chk.require(rep.returncode == 0, "tools/obs_report.py --check exit 0")

    # the same spans in a torch.profiler capture of one resilient fit
    from torch.profiler import ProfilerActivity, profile

    obs.enable(profile=True)
    fit = failing()  # fresh failure budgets; the retry rung alone
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        resilient_fit(fit, yf, order=entry.ORDER, device=device,
                      ladder=default_ladder(arima.fit)[:1])
    obs.disable()
    names = {e.key for e in prof.key_averages()}
    spans = ("sanitize", "fit.primary", "fit.rung.retry")
    chk.require(all(s in names for s in spans),
                f"profiler ranges {[s for s in spans if s in names]}")
    del yf

    # the warm fit's wall with the plane off and on, in turns
    y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
    onoff = {"off": [], "on": []}
    for state in ("off", "on", "off", "on"):
        if state == "on":
            obs.enable(str(OBS_DIR / "events_onoff.jsonl"))
        t0 = time.perf_counter()
        resilient_fit(arima.fit, y, order=entry.ORDER, device=device)
        onoff[state].append(time.perf_counter() - t0)
        obs.disable()
    out["obs_off_on_s"] = onoff
    log(f"  warm resilient fit, plane off {onoff['off']} s, on "
        f"{onoff['on']} s")
    del y

    stats = compile_cache.program_cache_stats()
    out["program_cache"] = stats
    log(f"  compile_cache.program_cache_stats() {stats} ({n_built} "
        "libraries built in phase 2)")
    from spark_timeseries_tpu_torch.ops import _build

    loaded = {_build.library_path(*k) for k in _build._libs}
    chk.require(stats["misses"] == n_built
                and stats["hits"] + stats["misses"] == len(_build._counted)
                and loaded <= _build._counted,
                "program cache: a miss per library built, a hit per library "
                f"found built, each counted once ({len(loaded)} loaded)")
    return out


def build() -> int:
    """Phase 2: every source at once, then load each library; returns how
    many libraries it built."""
    from spark_timeseries_tpu_torch.ops import _build

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
        if name.startswith(("libhw", "libgarch", "libhr", "libfill",
                            "libautocorr", "libcss")):  # each kernel
            for kern, info in _ptxas_entries(text):
                # of the variants, hr.cu, the transforms and the CSS lag
                # route, the path's instantiations
                if ((name.startswith("libcss")
                     and not kern.startswith(("css_fwd_lag_k<0, 3",
                                              "css_fwd_lag_k<3, 3",
                                              "css_bwd_lag_k<0, 3",
                                              "css_bwd_lag_k<3, 3")))
                        or (name.startswith("libhr") and "<4>" not in kern)
                        or (name.startswith(("libfill", "libautocorr"))
                            and not kern.endswith(("k<2>", "k<20>")))
                        or (name.startswith("libhw-STS_")
                            and "hw_fwd_k<24," not in kern)):
                    continue
                log(f"    {kern}: {info}")
    garch_report()
    hw_hr_report()
    transforms_report()
    css_report()
    return len(logs)


def _ptxas_entries(text: str):
    """(kernel, "R registers, F B stack frame, S B spill stores, M B static
    smem") for each entry function of a ``-Xptxas=-v`` log, template
    arguments decoded from the mangled name (``hw_fwd_k<24, 1>`` = period
    24, multiplicative; period 0 is the global-ring route)."""
    out = []
    for part in text.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        regs = re.search(r"Used (\d+) registers", part)
        frame = re.search(r"(\d+) bytes stack frame", part)
        spill = re.search(r"(\d+) bytes spill stores", part)
        smem = re.search(r"(\d+) bytes smem", part)
        out.append((_kernel_name(mangled),
                    f"{regs.group(1) if regs else '?'} registers, "
                    f"{frame.group(1) if frame else '?'} B stack frame, "
                    f"{spill.group(1) if spill else '?'} B spill stores, "
                    f"{smem.group(1) if smem else 0} B static smem"))
    return out


def _kernel_name(mangled: str) -> str:
    """``hw_fwd_k<24, 1>`` from a kernel's mangled name (the length-prefixed
    identifier ending in ``_k``, then its integer template arguments)."""
    for i in range(len(mangled)):  # a length prefix may follow a digit
        m = re.match(r"\d+", mangled[i:])
        if m is None:
            continue
        end = i + m.end()
        name = mangled[end:end + int(m.group())]
        if name.endswith("_k") and name.isidentifier():
            rest = mangled[end + len(name):]
            args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
            if args is None:
                return name
            vals = re.findall(r"L[ib](\d+)E", args.group(1))
            return f"{name}<{', '.join(vals)}>"
    return mangled


def _sass_main_loops(path, lds=None) -> dict:
    """``{kernel: (instructions, shared loads)}`` of each kernel's main loop
    in ``cuobjdump -sass`` of the library at ``path``: of the spans that
    end in a backward branch, the one with the most shared loads (``LDS``,
    one a panel a step), or with exactly ``lds`` of them, the shortest of
    those (the steady-state loop, not the one refilling the last stages).
    Empty when the toolkit has no ``cuobjdump``."""
    from spark_timeseries_tpu_torch.ops import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return {}
    return _sass_loops(subprocess.run(
        [str(tool), "-sass", str(path)], capture_output=True, text=True,
        timeout=300, check=True).stdout, lds)


def _sass_loops(text: str, lds=None) -> dict:
    """:func:`_sass_main_loops` on the text of a ``cuobjdump -sass``."""
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        lines = func.splitlines()
        labels, pending, instrs = {}, [], []
        for line in lines[1:]:
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if m:
                addr = int(m.group(1), 16)
                labels.update((name, addr) for name in pending)
                pending = []
                words = m.group(2).split()
                if words[0] == "@!PT":  # never issued: scheduling padding
                    continue
                op = words[1] if words[0].startswith("@") else words[0]
                instrs.append((addr, op.split(".")[0], m.group(2)))
        best = (0, 0)
        for addr, op, ins in instrs:
            if op != "BRA":
                continue
            tm = re.search(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b", ins)
            if tm is None:
                continue
            target = (labels.get(tm.group(1)) if tm.group(1)
                      else int(tm.group(2), 16))
            if target is None or target > addr:
                continue
            body = [o for a, o, _ in instrs if target <= a <= addr]
            if lds is None or body.count("LDS") == lds:
                best = max(best, (body.count("LDS"), -len(body)))
        out[_kernel_name(lines[0].strip())] = (-best[1], best[0])
    return out


def _max_sm_clock() -> str:
    """The card's highest SM clock in MHz, as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0]


def _issue_floor_ms(per_step: float, n_el: int) -> float:
    """Least milliseconds to issue ``per_step`` warp instructions for each
    of ``n_el`` thread-steps: one warp instruction a clock on each of an
    SM's four schedulers at the highest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * per_step * n_el / 32 / (sms * 4 * float(_max_sm_clock())
                                         * 1e6)


def hw_hr_report() -> None:
    """The Holt-Winters forward's and the moment sweep's rings: layout,
    dynamic shared memory, blocks an SM and waves (from the card), then the
    SASS instructions a step of each steady loop (every build timed) and
    the issue floor they imply at the path's shapes."""
    from spark_timeseries_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    m, n_mult = 24, min(100_000, HOURLY_ROWS)
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)


    def waves(rows_list):
        slots = blocks.value * sms
        return "; ".join(
            f"B={r}: {-(-r // 256)} blocks over {slots} slots = "
            f"{-(-r // 256) / max(slots, 1):.2f} waves" for r in rows_list)

    hw = _build.load("hw")
    stages, steps = ctypes.c_int(0), ctypes.c_int(0)
    hw.sts_hw_ring_layout(m, ctypes.byref(stages), ctypes.byref(steps))
    log(f"  hw_fwd y ring at m={m} as shipped: {stages.value} stages of "
        f"{steps.value} steps, seasonal ring in registers")
    for mult, save in ((0, 0), (0, 1), (1, 0), (1, 1)):
        rc = hw.sts_hw_occupancy(m, mult, save, ctypes.byref(blocks),
                                 ctypes.byref(smem))
        if rc:
            raise RuntimeError(f"sts_hw_occupancy failed: {rc}")
        log(f"    hw_fwd_k<{m}, {mult}, {save}> "
            f"({'mult.' if mult else 'add.'}, {'save' if save else 'sum'}): "
            f"{smem.value} B dynamic smem a block, {blocks.value} blocks an "
            f"SM; {waves((n_mult, HOURLY_ROWS))}")
    hr = _build.load("hr")
    rc = hr.sts_hr_occupancy(ctypes.byref(blocks), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"sts_hr_occupancy failed: {rc}")
    log(f"  hr_moments_k<4> ring: D = {hr.sts_hr_ring_depth()} steps "
        f"shipped: {smem.value} B dynamic smem a block, {blocks.value} "
        f"blocks an SM; {waves((ROWS,))}")
    for name, what in (("hw", "shipped"), ("hr", "shipped")):
        loops = _sass_main_loops(_build.library_path(name))
        if not loops:
            log("    cuobjdump not found: no SASS counts")
            return
        for kern, (n_ins, n_lds) in sorted(loops.items()):
            if name == "hw" and kern.startswith(f"hw_fwd_k<{m},"):
                n_el = HOURLY_TIME * (n_mult if ", 1, " in kern
                                      else HOURLY_ROWS)
                shape = (f"[{HOURLY_TIME}, "
                         f"{n_mult if ', 1, ' in kern else HOURLY_ROWS}]")
            elif name == "hr" and kern == "hr_moments_k<4>":
                n_el, shape = 2 * (TIME - 1) * ROWS, f"[{TIME - 1}, {ROWS}] x 2"
            else:
                continue
            if n_lds < 1:
                log(f"    {name} {what} {kern}: no loop with shared loads")
                continue
            per_step = n_ins / n_lds
            log(f"    {name} {what} {kern}: steady loop {n_ins} SASS "
                f"instructions for {n_lds} steps = "
                f"{per_step:.1f} a step; issue floor at {shape} "
                f"{_issue_floor_ms(per_step, n_el):.3f} ms")


def transforms_report() -> None:
    """The fill chain's ring and the autocorrelation's tile at the
    volatility pipeline's shape: dynamic shared memory and blocks an SM
    (from the card), then the SASS instructions a step of each build's
    steady loop (the fill chain's streamed walk; the autocorrelation
    tile's lag-product walk, its third pass alone) and the issue floor
    they imply."""
    from spark_timeseries_tpu_torch.ops import _build

    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = _build.load("fill").sts_fill_occupancy(ctypes.byref(blocks),
                                                ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"sts_fill_occupancy failed: {rc}")
    log(f"  fill_chain_k<2> ring: D = "
        f"{_build.load('fill').sts_fill_ring_depth()} steps shipped: "
        f"{smem.value} B dynamic smem a block, {blocks.value} blocks an SM")
    acf = _build.load("autocorr")
    rc = acf.sts_autocorr_occupancy(VOL_TIME, 20, ctypes.byref(blocks),
                                    ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"sts_autocorr_occupancy failed: {rc}")
    log(f"  autocorr at T={VOL_TIME}, 20 lags, shipped tile S="
        f"{acf.sts_autocorr_tile()} ({_acf_route(VOL_TIME, 20)}): "
        f"{smem.value} B dynamic smem a block, {blocks.value} blocks an SM")
    n_el = VOL_ROWS * VOL_TIME
    for name, what in (("fill", "shipped"), ("autocorr", "shipped")):
        # the tile's lag-product walk: 20 steps, one shared load each
        loops = _sass_main_loops(_build.library_path(name),
                                 20 if name == "autocorr" else None)
        if not loops:
            log("    cuobjdump not found: no SASS counts")
            return
        for kern, (n_ins, n_lds) in sorted(loops.items()):
            if kern not in ("fill_chain_k<2>", "autocorr_tile_k<20>"):
                continue
            if n_lds < 1:
                log(f"    {name} {what} {kern}: no loop with shared loads")
                continue
            per_step = n_ins / n_lds
            log(f"    {name} {what} {kern}: steady loop {n_ins} SASS "
                f"instructions for {n_lds} steps = {per_step:.1f} a step; "
                f"issue floor at [{VOL_TIME}, {VOL_ROWS}] "
                f"{_issue_floor_ms(per_step, n_el):.3f} ms")


def garch_report() -> None:
    """The GARCH kernels' ring: depth, shared memory and blocks an SM (from
    the card), SASS instructions a step of each kernel's main loop and the
    issue-rate floor they imply at the pipeline's shape (one warp
    instruction a clock on each of an SM's four schedulers)."""
    from spark_timeseries_tpu_torch.ops import _build

    lib = _build.load("garch")
    depth = lib.sts_garch_ring_depth()
    log("  issue floors below: one warp instruction a clock on each of 4 "
        f"schedulers of {torch.cuda.get_device_properties(0).multi_processor_count}"
        f" SMs at {_max_sm_clock()} MHz")
    log(f"  garch ring: depth D = {depth} steps shipped")
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    for k, what in enumerate(("forward (sum)", "adjoint, per-series "
                              "cotangent, with dr", "adjoint, [T, B] "
                              "cotangent")):
        rc = lib.sts_garch_occupancy(k, ctypes.byref(blocks),
                                     ctypes.byref(smem))
        if rc:
            raise RuntimeError(f"sts_garch_occupancy({k}) failed: {rc}")
        log(f"    {what}: {smem.value} B dynamic smem a block, "
            f"{blocks.value} blocks an SM")
    n_el = VOL_ROWS * VOL_TIME
    for d in (depth,):
        loops = _sass_main_loops(_build.library_path("garch"))
        if not loops:
            log("    cuobjdump not found: no SASS counts")
            return
        for kern, (n_ins, n_lds) in sorted(loops.items()):
            panels = 1 if "fwd" in kern else (2 if "<1" in kern else 3)
            if not n_lds:
                log(f"    D={d} {kern}: no loop with shared loads found")
                continue
            per_step = n_ins * panels / n_lds
            log(f"    D={d} {kern}: main loop {n_ins} SASS instructions "
                f"for {n_lds // panels} steps = {per_step:.1f} a step; "
                f"issue floor at [{VOL_TIME}, {VOL_ROWS}] "
                f"{_issue_floor_ms(per_step, n_el):.3f} ms")


def css_report() -> None:
    """The CSS lag route at the airline model's support: dynamic shared
    memory and blocks an SM (from the card), SASS instructions a step of
    the forward's and the adjoint's main loops and the issue-rate floor
    they imply at the airline fit's shape [935, 1M]."""
    from spark_timeseries_tpu_torch.ops import _build

    lib = _build.load("css")
    blocks, smem = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    rc = lib.sts_css_lag_occupancy(SEASON, blocks, smem)
    if rc:
        raise RuntimeError(f"sts_css_lag_occupancy failed: {rc}")
    for i, what in enumerate(("forward", "adjoint, per-series cotangent")):
        log(f"  css lag route, airline {what}: {smem[i]} B dynamic smem a "
            f"block of 128 threads, {blocks[i]} blocks an SM")
    loops = _sass_main_loops(_build.library_path("css"))
    if not loops:
        log("    cuobjdump not found: no SASS counts")
        return
    n_el = (HOURLY_TIME - 1 - SEASON) * HOURLY_ROWS
    # shared loads a step: the streamed panel's word and the three MA lags
    for kern in ("css_fwd_lag_k<0, 3>", "css_bwd_lag_k<0, 3, 1>"):
        n_ins, n_lds = loops.get(kern, (0, 0))
        if not n_lds:
            log(f"    {kern}: no loop with shared loads found")
            continue
        per_step = n_ins * 4 / n_lds
        log(f"    {kern}: main loop {n_ins} SASS instructions for "
            f"{n_lds // 4} steps = {per_step:.1f} a step; issue floor at "
            f"[{HOURLY_TIME - 1 - SEASON}, {HOURLY_ROWS}] "
            f"{_issue_floor_ms(per_step, n_el):.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    device = torch.device("cuda", 0)
    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()
    n_built = build()

    chk = Checks()
    phase_kernels(chk, device)
    phase_kernels_volatility(chk, device)
    check_garch_divide(chk, device)
    check_hw_divide(chk, device)
    phase_kernels_smoothing(chk, device)
    phase_kernels_seasonal(chk, device)
    if chk.failures:  # a kernel that disagrees makes the rest meaningless
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    main_run = phase_main(chk, ROWS, TIME, device)
    pipe = phase_pipeline(chk, VOL_ROWS, VOL_TIME, device)
    hourly = phase_hourly(chk, HOURLY_ROWS, HOURLY_TIME, device)
    times = phase_timing(chk, main_run, device)
    times.update(phase_timing_volatility(chk, pipe, device))
    times.update(phase_timing_hourly(chk, hourly, device))
    lag = phase_timing_seasonal(chk, device)
    search = phase_order_search(chk, device)
    phase_leftovers(chk, main_run.pop("params"), device)
    resilient = phase_resilient(chk, device, n_built)
    log(json.dumps({"css_lag_route": {
        "shape": [HOURLY_TIME - 1 - SEASON, HOURLY_ROWS], "times": lag,
        "launches": {"airline fit (8b)": search["airline_launches"],
                     "seasonal grid (8c)": search["grid_seasonal_launches"]},
        "walls_s": {k: v for k, v in search.items() if k.endswith("_s")}}}))
    log(json.dumps({"resilient_fit": resilient}))
    if chk.failures:
        log("FAILED: " + "; ".join(chk.failures))
        return 1
    launches = {**main_run["launches"],
                **{k: pipe["launches"][k] for k in
                   ("fill_chain", "autocorr", "garch_fwd", "garch_bwd")},
                **{k: hourly["launches"][k] for k in
                   ("ewma_fwd", "ewma_bwd", "hw_fwd", "hw_bwd")}}
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": launches[name],
        "max_abs_err": chk.max_abs[name], "ms": ms, "plain_ms": plain,
        "bound_ms": bms, "bound_by": by, "library_ms": None,
    } for name, (ms, plain, bms, by) in times.items()]
    log(f"all phases in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

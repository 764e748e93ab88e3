#!/usr/bin/env python3
"""Smoke run of the PyTorch port (spark_timeseries_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases; each failure makes the script exit non-zero with no result line:

1. require a CUDA device; print the card's name and power limit;
2. build the CUDA kernels from the eight sources in
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
3b. hold the optimizer's three kernels (``csrc/lbfgs.cu``: the L-BFGS
   direction, a line-search trial, the update) against their plain
   versions, on inputs that take every branch, and time them at [1M, 3] and [13,312, 3] with m = 8, beside
   their byte bounds (a JSON line ``{"lbfgs_kernels": ...}``);
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
   exact, the primary rung (the panel), the retry rung (32 padded rows)
   and the fallback rung (``backend="auto"``, 16 padded rows, no
   compaction) must each run the CSS kernels on the register route, the
   primary also ``hr_moments`` and the other two none, and the OK rows
   must match a plain fit of the sanitized panel bit for bit, the same
   faulted fit again to the same bits; then ``tools/obs_report.py
   --check`` on the
   stream, the port's ``validate_textfile`` on the textfile, the device
   source of ``obs.peak_memory()``, the span names in a
   ``torch.profiler`` capture, the warm fit's wall with the plane off and
   on, and the kernel libraries' program-cache counts.
10. drive the journaled chunk walk (``reliability.fit_chunked(arima.fit,
   ...)``) over the 1,000,000 x 1,000 headline panel in four chunks of
   250,000 rows, the journals under ``chiprun_out/chip_smoke_chunked/``
   (cleared first; the shards deleted at the end, the manifests kept),
   with the launch counts set to 0 before each walk and read after it:
   ``hr_moments`` must run twice per chunk fitted in every walk.  (a) In
   memory, pipelined: four chunks committed in the background, each
   chunk bit for bit a plain ``resilient_fit`` of its rows under the
   walk's align mode; (b) serial == (a); (c) crashed by
   ``faultinject.crash_after_commits(2, mid_commit=True)``, then resumed:
   == (a), one chunk resumed, three refitted; (f) ``oom_fit`` at 100,000
   rows: two halvings (250,000 -> 125,000 -> 62,500), then == a plain
   walk at 62,500; (g) a delta walk of a copy with rows 500,000-502,499
   revised (``delta_warmstart=False``): three chunks adopted with no
   launch, one refitted, == the cold walk of the revised panel; (h) a
   write-back sink whose shards read back == (a); (d) host-resident
   (``HostChunkSource`` of a numpy copy, the panel freed on the card):
   == (a), ``h2d_bytes`` == the panel's bytes, peak device memory below
   (a)'s; (e) ``NpzShardSource`` of the first 250,000 rows == (a)'s rows.

11. drive the order search and the forecast walk over the headline
   panel, the journals in a temporary directory removed at the end, with
   the launch counts set to 0 before each step and read after it: (11a)
   ``models.auto.auto_fit`` of the six default orders (two fused groups
   through ``arima.fit_grid`` on the CSS kernels) in 250,000-row chunks;
   (11b) ``fuse=1`` against ``fuse="auto"`` on 100,000 rows: every
   flipped row's two orders within 1e-3 relative under both runs, the
   agreeing rows' params within 1e-2; (11c) 11a crashed after five
   chunk commits, then resumed: 11a bit for bit; (11d)
   ``stage2="winners"`` on the panel and the stepwise search on 100,000
   rows; (11e) ``forecasting.ensemble_forecast`` of 11a's search with
   ``temperature=0`` and 256-path bands over 30 steps in 62,500-row
   chunks, on the first 250,000 rows (the cut; the search's member fits
   of those rows): the point forecast bit for bit the per-row winner's
   ``forecast_chunked`` walk, and one chunk's draws, paths and band sort
   timed; the fused groups (``fit_grid``) and every member's point walk
   against ``backend="eager"`` on 10,000 rows (phase 8a's parity bar,
   1e-5); (11h) the chunk walk of phase 10 (a), ``resilient=False``, on
   a side CUDA stream, also under ``chunk_budget_s`` (the watchdog
   worker): the default-stream walk's bits; (11g)
   ``forecasting.run_backtest`` of ARIMA(1,1,1), four windows, 30 steps,
   journaled, then crashed after two commits and resumed: the same
   metrics bit for bit, and one window's parts timed; (11f)
   ``forecast_chunked`` of GARCH on the volatility panel and of EWMA and
   additive Holt-Winters on the hourly panel, each equal to the model's
   own ``forecast``.

12. drive the panel API, compat and the mesh (``phase_panel_mesh``),
   with the launch counts set to 0 before each step and read after it:
   (12a) a ``TimeSeriesPanel`` over the headline panel (the tensor taken
   without a copy): ``fill("linear")`` one ``fill_chain`` launch and
   ``autocorr(20)``, each bit for bit its ``ops.univariate`` batch
   function; ``fit("arima", chunk_rows=250_000, checkpoint_dir=...)`` and
   ``forecast("arima", 30, ...)`` bit for bit ``fit_chunked`` /
   ``forecast_chunked`` with the same knobs; walls of ``differences``,
   ``series_stats``, ``to_instants``, ``islice`` / ``select`` /
   ``with_index``; an npz round trip of 10,000 rows; ``from_observations``
   of 10,000 x 1,000 observations == the panel's rows.  (12b)
   ``compat.sparkts``: ``ARIMA.fit_model`` of the headline panel bit for
   bit ``arima.fit`` (journaled: ``fit_chunked``), ``forecast_panel`` ==
   ``forecast_chunked``, ``TimeSeriesRDD.map_series(mode="device")`` over
   1M rows, and the AR, GARCH, ARGARCH (100,000 x 2,520 returns made as in
   phase 5), EWMA and Holt-Winters (100,000 x 960 hourly rows) fits, each
   bit for bit its model module's, with their kernels' launches, every
   model through ``save`` -> ``load_model``.  (12c) ``default_mesh()`` on
   the card and a panel on it; a (1, 4) mesh listing the card four times:
   ``sp_moments``, ``sp_autocorr``, ``sp_cumsum``, ``sp_differences``,
   ``sp_fill_linear_chain`` (also on 100,000 hourly rows with their gaps)
   and ``sp_ewma_smooth`` over the headline panel against their unsharded
   counterparts, then ``sp_ewma_fit``, ``sp_garch_fit``,
   ``sp_argarch_fit`` and ``sp_arima_fit((1,1,1))`` on dense float64
   rows at the CPU tests' bars: EWMA and ARIMA on 100,000 rows against
   the models' unsharded fits, the GARCH pair on 25,000 rows against the
   same objective in one time cell.

13. drive the multi-lane chunk walk and the in-process serving loop
   (``phase_lanes_serving``), with the launch counts set to 0 before each
   step and read after it, and any quarantine, failed ticket, refusal or
   chunk fit without its kernels outside the injected faults a failed
   check: (13a) ``fit_chunked(arima.fit, ...)`` of the headline panel in
   125,000-row chunks on a series mesh listing the card four times (four
   lanes, each a thread on its own CUDA stream, two chunks each),
   journaled: the one-lane walk's bits and launches, one merged manifest
   (``merged_from_shards == 4``); ``lane_kill(fit, 1, after_chunks=1)``
   quarantined and reassigned, the same bits and launches;
   ``slow_lane(fit, 2, 3.0)`` at 62,500-row chunks (four a lane: a steal
   needs two unstarted chunks behind the straggler, and a stall the other
   lanes' whole walk fits in twice over on a slow host) stolen from, the
   one-lane walk's bits at that grid; ``crash_after_commits(3)`` then a
   resume, the same bits; the one- and four-lane walls, peaks and
   ``meta["shards"]``.  (13b) ``serving.FitServer(max_batch_rows=65,536,
   max_queue_rows=262,144, cell_rows=32,768, device="cuda")``: eight
   tenants of 32,768 ragged rows submitted from eight threads before the
   serve loop starts (so the batches are pairs whatever the disk), each bit
   for bit its rows walked alone and tenant 0 its solo request; a 30-step
   ``submit_forecast`` == the local forecast walk; an auto request on
   8,192 rows twice (routes new, then stable); an expired deadline (all
   rows TIMEOUT); a child server killed by SIGKILL mid-commit
   (``faultinject.server_kill(2)``) and a restarted child re-answering
   every request as an uninterrupted server does, bit for bit; the
   server's ``health()``.  (13c) ``run_backtest(y, "arima", 4,
   server=srv)`` on 10,000 rows with the local campaign's metrics, and
   ``serving.TickLoop`` over 100,000 x 1,000 npz shards (24 ticks a
   cycle, 30-step forecasts through the sink), three cycles, crashed
   after cycle 1's refit committed and resumed: every cycle publishes
   the uninterrupted loop's bytes.  The gloo multi-process walk runs in
   the CPU tests only (one process here).  Child mode:
   ``python3 chip_smoke.py --serve-child run|recover ROOT [OUT]``.

14. drive the wire and the fleet (``phase_wire_fleet``), with the launch
   counts set to 0 before each step and read after it: (14a) a
   ``serving.TransportServer`` armed with an HMAC secret in front of 13b's
   ``FitServer`` configuration: 13b's eight 32,768 x 1,000 ragged tenants
   from eight ``FitClient`` threads (131 MB a frame), admitted before the
   serve loop starts, each bit for bit 13b's in-process answer with 13b's
   launches and JSON-native meta; a wired ``submit_forecast`` == the
   in-process one; a wrong secret a terminal ``WireAuthError``; four
   tenants through a ``FaultyWire`` (``frame_fault_schedule`` with drops,
   duplicates and tears) the same bits; the wired wall beside 13b's.
   (14b) two ``FleetReplica`` child processes on one root (TTL 5 s, the
   servers 13b's SIGKILL child's, on the card through ``server_kwargs``);
   the primary ``server_kill(2, mid_commit=True)`` dies inside its second
   commit; in the leaderless window a write bounces (``not_leader`` or
   ``read_only``), a completed result is read from the standby, and a
   forecast is answered by the standby's scratch server, bit for bit; the
   standby wins a higher token and re-answers the in-flight requests bit
   for bit an uninterrupted server's; the bounced write lands;
   ``run_backtest(..., server=FitClient(endpoints))`` on 13c's panel ==
   13c's served backtest; the survivor launched the CSS and moment
   kernels.  (14c) the killed replica restarted (same owner, new pid)
   joins as a standby; ``ChaosRunner(chaos_schedule(18, 8.0, n_events=3,
   kinds=("kill", "pause")))`` (SIGKILL / SIGSTOP of the role's process)
   while ``request_storm`` paces eight requests through the client;
   ``check_invariants`` (conservation, bitwise re-answers, monotonic
   tokens, bounded unavailability) returns ``[]``; the chaos manifest is
   written and loads back.  Child mode: ``python3 chip_smoke.py
   --fleet-child ROOT OWNER DEVICE KILL|- CELL STATUS``.

The line before the last is a JSON object with one entry per kernel, and
earlier lines JSON objects with the lag route's times, bounds and
launches, with phase 9's walls, launches and counts, with phase 10's
(``{"chunked_walk": ...}``: walls and launches of each walk, the peaks
of device memory, the commit and staging overlap), with phase 11's
(``{"search_forecast": ...}``), with phase 12's (``{"panel_mesh":
...}``: walls, launches and peaks of each step, the fits' agreement) and
with phase 13's (``{"lanes_serving": ...}``: walls, launches and peaks of
each walk and request kind, the lanes' elastic records, the server's
health) and with phase 14's (``{"wire_fleet": ...}``: walls, launches and
peaks of each step, the wire faults, the children's roles, counters,
launches and peaks, the chaos run's fired events and windows);
the last line is ``{"ok": true, "device": {...}}``.
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
       "hw_fwd": 1e-6, "hw_bwd": 1e-6, "lbfgs_direction": 3.4e-7,
       "lbfgs_trial": 3.4e-7, "lbfgs_update": 3.4e-7}

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


LBFGS_ROWS = (1_000_000, 13_312)  # a whole hourly fit; GARCH's stragglers
LBFGS_D, LBFGS_M = 3, 8  # GARCH's and Holt-Winters' widths, the history


def _lbfgs_state(b: int, device, seed: int = 7):
    """A mid-run optimizer state of ``b`` rows (``ops.lbfgs_kernels``'
    layout): a full ring with some slots invalid, 2 % of rows done."""
    from spark_timeseries_tpu_torch.utils import optim

    d, m = LBFGS_D, LBFGS_M
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    ru = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731
    x, g = rn(b, d), rn(b, d)
    s = 0.2 * rn(b, m, d)
    y = s * (0.5 + ru(b, m, 1)) + 0.05 * rn(b, m, d)
    rho = 1.0 / (s * y).sum(-1)
    rho = torch.where(ru(b, m) < 0.2, -rho.abs(), rho)
    f = ru(b) * 3
    done = ru(b) < 0.02
    return optim._State(x, f, g, s, y, rho, done, torch.zeros_like(done),
                        0.05 + ru(b), x.clone(), f + 0.01, g.clone(),
                        torch.full((b,), 9, dtype=torch.int32,
                                   device=device))


def _lbfgs_trial_inputs(st, dr, t, gen):
    """Objective values at a trial that take every branch of the trial's
    arithmetic: ``f(t) - f`` spread over [-3, 5] x |g.dir t|, so rows pass,
    backtrack inside the clamp or at 0.1 t; 1 % NaN and 1 % inf."""
    u = torch.rand(2, t.shape[0], generator=gen, device=t.device)
    fnew = st.f + (dr.gd * t).abs() * (8.0 * u[0] - 3.0)
    fnew = torch.where(u[1] < 0.01, math.nan, fnew)
    return torch.where((u[1] >= 0.01) & (u[1] < 0.02), math.inf, fnew)


def _lbfgs_update_inputs(st, xt, gen, tol: float, ftol: float):
    """The objective's raw value and gradient at ``xt`` for an update that
    takes every branch, one group of rows each -> (fn, gn, groups): a NaN
    value, an infinite gradient, a step refused at the re-evaluation, a
    relative decrease and a gradient norm each within half of its
    threshold (``ftol``, ``tol``) either way, no curvature, and the rest
    accepted with curvature."""
    u = torch.rand(2, xt.shape[0], generator=gen, device=xt.device)
    edges = {"nan_f": 0.01, "inf_g": 0.02, "refused": 0.17, "near_ftol": 0.27,
             "near_tol": 0.37, "no_curv": 0.47}
    groups, lo = {}, 0.0
    for name, hi in edges.items():
        groups[name] = (u[0] >= lo) & (u[0] < hi)
        lo = hi
    s, near = xt - st.x, 0.5 + u[1]
    fn = st.f - 0.1
    fn = torch.where(groups["refused"], st.f + 0.1, fn)
    fn = torch.where(groups["near_ftol"],
                     st.f - ftol * st.f.abs().clamp(min=1.0) * near, fn)
    fn = torch.where(groups["nan_f"], math.nan, fn)
    gn = st.g + 1.5 * s
    scale = tol * xt.norm(dim=-1).clamp(min=1.0) / st.g.norm(dim=-1)
    gn = torch.where(groups["near_tol"][:, None],
                     st.g * (scale * near)[:, None], gn)
    gn = torch.where(groups["no_curv"][:, None], st.g - 1.5 * s, gn)
    gn[:, 0] = torch.where(groups["inf_g"], math.inf, gn[:, 0])
    return fn, gn, groups


def phase_lbfgs(chk: Checks, device) -> dict:
    """The optimizer's three kernels (``csrc/lbfgs.cu``) against their plain
    versions summing in the kernels' order, then timed at [1M, 3] (a whole
    hourly fit's lockstep stage) and [13,312, 3] (GARCH's compacted
    stragglers), m = 8, beside their byte bounds.

    The comparison feeds both sides the same inputs, which take every
    branch (and the phase checks that they do): two trials whose rows
    pass, backtrack on a finite value inside the clamp and at it, and
    backtrack on a non-finite one; an update whose rows are accepted with
    and without curvature, refused at the re-evaluation, converge by
    either test, carry a non-finite value or gradient, or fail (their line
    search did not pass).  The timings make every row work: all backtrack
    in the trial, every update is accepted."""
    from spark_timeseries_tpu_torch.ops import lbfgs_kernels as lk

    log("phase 3b: the optimizer's kernels (csrc/lbfgs.cu), d = "
        f"{LBFGS_D}, m = {LBFGS_M}")
    d, m, k = LBFGS_D, LBFGS_M, 9
    tol, ftol = 1e-4, 1e-6
    direction_plain = functools.partial(lk.lbfgs_direction_plain, lanes=True)
    update_plain = functools.partial(lk.lbfgs_update_plain, lanes=True)
    out = {}
    for b in LBFGS_ROWS:
        st = _lbfgs_state(b, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(b)
        fl = torch.zeros(2, dtype=torch.int32, device=device)
        fl_p = fl.clone()
        dargs = (st.x, st.f, st.g, st.s_hist, st.y_hist, st.rho_hist,
                 st.tprev, st.converged, st.failed, k, ftol)
        dk = lk.lbfgs_direction(*dargs, fl)
        dp = direction_plain(*dargs, fl_p)
        for name in ("direction", "t", "gd", "eps", "xt"):
            chk.compare("lbfgs_direction", f"{name}, [{b}, {d}]",
                        getattr(dk, name), getattr(dp, name))
        chk.require(torch.equal(dk.ok, dp.ok), f"lbfgs_direction ok [{b}]")

        # two trials from the kernel's direction, on both sides
        tk = [a.clone() for a in (dk.t, dk.ok, dk.xt)]
        tp = [a.clone() for a in tk]
        for trial in (1, 2):
            fnew = _lbfgs_trial_inputs(st, dk, tk[0], gen)
            t0, was_ok = tk[0].clone(), tk[1].clone()
            lk.lbfgs_trial(st.x, dk.direction, st.f, dk.gd, dk.eps, fnew,
                           *tk, fl, trial, 1e-4)
            lk.lbfgs_trial_plain(st.x, dk.direction, st.f, dk.gd, dk.eps,
                                 fnew, *tp, fl_p, trial, 1e-4)
            chk.compare("lbfgs_trial", f"t {trial}, [{b}, {d}]", tk[0],
                        tp[0])
            chk.compare("lbfgs_trial", f"xt {trial}, [{b}, {d}]", tk[2],
                        tp[2])
            chk.require(torch.equal(tk[1], tp[1])
                        and torch.equal(fl[0], fl_p[0]),
                        f"lbfgs_trial {trial} ok and flag [{b}]")
            back = ~tp[1]
            finite = torch.isfinite(fnew)
            at_clamp = back & finite & (tp[0] == 0.1 * t0)
            taken = {"passed": tp[1] & ~was_ok, "at clamp": at_clamp,
                     "inside clamp": back & finite & ~at_clamp,
                     "non-finite": back & ~finite}
            chk.require(all(bool(v.any()) for v in taken.values()),
                        f"lbfgs_trial {trial} takes every branch [{b}]: "
                        + ", ".join(f"{n} {int(v.sum())}"
                                    for n, v in taken.items()))

        # the update after the trials: their ok (rows that still backtrack
        # fail), on both sides from the same inputs
        fn, gn, groups = _lbfgs_update_inputs(st, tk[2], gen, tol, ftol)
        ring_k = [a.clone() for a in (st.s_hist, st.y_hist, st.rho_hist)]
        ring_p = [a.clone() for a in ring_k]
        uargs = (st.x, st.f, st.g, tk[2], fn, gn, tk[0], tk[1],
                 st.converged, st.failed, st.tprev, st.bx, st.bf, st.bg,
                 st.iters)
        uk = lk.lbfgs_update(*uargs, *ring_k, k, tol, ftol, fl)
        up = update_plain(*uargs, *ring_p, k, tol, ftol, fl_p)
        for i, (a, e) in enumerate(zip(uk + tuple(ring_k),
                                       up + tuple(ring_p))):
            if a.dtype.is_floating_point:
                chk.compare("lbfgs_update", f"output {i}, [{b}, {d}]", a, e)
            else:
                chk.require(torch.equal(a, e), f"lbfgs_update output {i} "
                            f"[{b}]")
        chk.require(torch.equal(fl, fl_p), f"lbfgs_update live count [{b}]")
        done = st.converged | st.failed
        accepted = up[0].ne(st.x).any(-1)
        written = ring_p[2][:, k % m].ne(st.rho_hist[:, k % m])
        conv_new = up[3] & ~done
        taken = {"accepted": accepted, "written": written,
                 "accepted, no curvature": accepted & ~written,
                 "refused": tk[1] & ~done & ~accepted,
                 "converged on the fall": conv_new & groups["near_ftol"],
                 "live near ftol": accepted & ~conv_new & groups["near_ftol"],
                 "converged on the gradient": conv_new & groups["near_tol"],
                 "live near tol": accepted & ~conv_new & groups["near_tol"],
                 "failed": up[4] & ~st.failed,
                 "non-finite": (groups["nan_f"] | groups["inf_g"])
                 & ~accepted & ~done}
        chk.require(all(bool(v.any()) for v in taken.values()),
                    f"lbfgs_update takes every branch [{b}]: "
                    + ", ".join(f"{n} {int(v.sum())}"
                                for n, v in taken.items()))

        # bytes a row: the direction reads x, g, f, tprev, the ring and two
        # flags and writes the direction, the trial point, t, gd, eps and
        # ok; a trial reads ok, fnew, t, f, gd, eps, x, dir and writes t
        # and the trial point; the update reads x, g, xn, gn, bx, bg, f,
        # fn, t, tprev, bf, iters and three flags and writes x, g, bx, bg,
        # f, tprev, bf, iters, two flags and a ring slot (s, y, rho)
        fb, ring = 4, 4 * (2 * m * d + m)
        per_row = {
            "lbfgs_direction": (fb * (2 * d + 2) + ring + 2
                                + fb * (2 * d + 3) + 1),
            "lbfgs_trial": 1 + fb * (5 + 2 * d) + fb * (1 + d),
            "lbfgs_update": (fb * (6 * d + 6) + 3 + fb * (4 * d + 4) + 2
                             + fb * (2 * d + 1)),
        }
        # the timed inputs: every row backtracks, every update is accepted
        fnew_all = torch.full_like(st.f, math.inf)
        tk = [dk.t.clone(), torch.zeros_like(dk.ok), dk.xt.clone()]
        tp = [a.clone() for a in tk]
        uargs = (st.x, st.f, st.g, dk.xt, st.f - 0.1,
                 st.g + 1.5 * (dk.xt - st.x), dk.t, torch.ones_like(dk.ok),
                 st.converged, st.failed, st.tprev, st.bx, st.bf, st.bg,
                 st.iters)

        def run_direction():
            lk.lbfgs_direction(*dargs, fl)

        def run_direction_plain():
            direction_plain(*dargs, fl_p)

        def run_trial():
            lk.lbfgs_trial(st.x, dk.direction, st.f, dk.gd, dk.eps, fnew_all,
                           *tk, fl, 1, 1e-4)

        def run_trial_plain():
            lk.lbfgs_trial_plain(st.x, dk.direction, st.f, dk.gd, dk.eps,
                                 fnew_all, *tp, fl_p, 1, 1e-4)

        def run_update():
            lk.lbfgs_update(*uargs, *ring_k, k, tol, ftol, fl)

        def run_update_plain():
            update_plain(*uargs, *ring_p, k, tol, ftol, fl_p)

        for name, fn_, plain in (
                ("lbfgs_direction", run_direction, run_direction_plain),
                ("lbfgs_trial", run_trial, run_trial_plain),
                ("lbfgs_update", run_update, run_update_plain)):
            ms = cuda_ms(fn_, reps=20)
            pms = cuda_ms(plain, reps=5)
            bms = per_row[name] * b / HBM_BYTES_PER_S * 1e3
            out[f"{name}@{b}"] = {"ms": ms, "plain_ms": pms, "bound_ms": bms,
                                  "bytes_per_row": per_row[name],
                                  "share_of_bound": bms / ms}
            log(f"  {name:16s} [{b:>9,}, {d}] {ms:8.4f} ms  plain "
                f"{pms:8.3f} ms  bound {bms:.4f} ms ({per_row[name]} B a row,"
                f" {100 * bms / ms:.0f} %)")
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


CHUNK_ROWS = 250_000  # phase 10's chunk: four chunks of the headline panel
NPZ_ROWS = 250_000  # (e)'s npz cut: 1 GB on disk
OOM_ROWS = 100_000  # (f): oom_fit's row limit, so 250k -> 125k -> 62,500
REVISED = (500_000, 502_500)  # (g): revised rows, in the third chunk
CHUNKED_DIR = (Path(__file__).resolve().parent / "chiprun_out"
               / "chip_smoke_chunked")
_FIT_FIELDS = ("params", "neg_log_likelihood", "converged", "iters",
               "status")


def _same_walk(a, b, rows=None) -> bool:
    """Every field of two walk results the same bits (``rows`` of ``a``
    when given), NaNs at the same places."""
    import numpy as np

    sl = slice(None) if rows is None else slice(*rows)
    return all(np.array_equal(np.asarray(getattr(a, f))[sl],
                              np.asarray(getattr(b, f)),
                              equal_nan=np.asarray(getattr(b, f)).dtype.kind
                              == "f")
               for f in _FIT_FIELDS)


def _committed(d: Path) -> list:
    m = json.loads((d / "manifest.json").read_text())
    return [(c["lo"], c["hi"]) for c in m["chunks"]
            if c["status"] == "committed"]


def phase_chunked(chk: Checks, device) -> dict:
    """Phase 10: the journaled chunk walk (``reliability.fit_chunked``)
    over the headline panel, in memory, host-resident and from npz
    shards, with crash and resume, OOM backoff, a delta walk and a sink."""
    import shutil

    import numpy as np

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import (HostChunkSource,
                                                        NpzShardSource,
                                                        faultinject as fi,
                                                        fit_chunked,
                                                        resilient_fit,
                                                        write_npz_shards)

    n_chunks = ROWS // CHUNK_ROWS
    log(f"phase 10: journaled chunk walk, ARIMA(1,1,1) on {ROWS} x {TIME} "
        f"in chunks of {CHUNK_ROWS}, journals under {CHUNKED_DIR}")
    shutil.rmtree(CHUNKED_DIR, ignore_errors=True)
    CHUNKED_DIR.mkdir(parents=True)
    out = {"walls_s": {}, "launches": {}, "peak_gib": {}}
    t_phase = time.perf_counter()

    def walk(name, fit, panel, fitted, **kw):
        """One fit_chunked walk with the launch counts set to 0 just before
        it and read just after, and the allocator's peak reset before it;
        ``fitted`` is how many chunk fits it must run (None: not known)."""
        kw.setdefault("chunk_rows", CHUNK_ROWS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return fit_chunked(fit, panel, order=entry.ORDER, device=device,
                               **kw)
        finally:
            torch.cuda.synchronize()
            out["walls_s"][name] = time.perf_counter() - t0
            la = {k: ck.LAUNCHES[k] for k in ("css_fwd", "css_bwd",
                                              "hr_moments")}
            out["launches"][name] = la
            out["peak_gib"][name] = (torch.cuda.max_memory_allocated(device)
                                     / 2**30)
            log(f"  {name}: {out['walls_s'][name]:.3f} s, launches {la}, "
                f"peak {out['peak_gib'][name]:.2f} GiB")
            if fitted is not None:
                chk.require(la["hr_moments"] == 2 * fitted
                            and la["css_fwd"] > 0 and la["css_bwd"] > 0,
                            f"{name}: hr_moments launched 2 x {fitted} "
                            "chunk fits, the CSS kernels ran")

    y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
    torch.cuda.synchronize()

    # (a) the in-memory walk, pipelined, journaled
    dir_a = CHUNKED_DIR / "a"
    a = walk("a in memory", arima.fit, y, n_chunks, checkpoint_dir=str(dir_a),
             pipeline=True)
    pipe_a = a.meta["pipeline"]
    mode = a.meta["align_mode"]
    chk.require(_committed(dir_a) == [(lo, lo + CHUNK_ROWS) for lo in
                                      range(0, ROWS, CHUNK_ROWS)],
                f"(a) the manifest holds the {n_chunks} chunks committed")
    chk.require(pipe_a["commits_background"] == n_chunks,
                f"(a) {pipe_a['commits_background']} commits in the "
                "background")
    t0 = time.perf_counter()
    per_chunk = [resilient_fit(arima.fit, y[lo:lo + CHUNK_ROWS],
                               order=entry.ORDER, device=device,
                               align_mode=mode)
                 for lo in range(0, ROWS, CHUNK_ROWS)]
    out["walls_s"]["(a)'s chunks as plain resilient fits"] = (
        time.perf_counter() - t0)
    chk.require(all(_same_walk(a, r, (lo, lo + CHUNK_ROWS)) for lo, r in
                    zip(range(0, ROWS, CHUNK_ROWS), per_chunk)),
                f"(a) each chunk == resilient_fit of its rows under "
                f"align_mode {mode!r}, bit for bit")
    del per_chunk

    # (b) the same walk, serial
    b = walk("b serial", arima.fit, y, n_chunks,
             checkpoint_dir=str(CHUNKED_DIR / "b"), pipeline=False)
    chk.require(_same_walk(a, b), "(b) serial == (a) bit for bit")
    del b

    # (c) crash mid-commit after the second shard, then resume
    dir_c = CHUNKED_DIR / "c"
    crashed = False
    try:
        walk("c crashed", arima.fit, y, None, checkpoint_dir=str(dir_c),
             _journal_commit_hook=fi.crash_after_commits(2, mid_commit=True))
    except fi.SimulatedCrash:
        crashed = True
    done = _committed(dir_c)
    chk.require(crashed and done == [(0, CHUNK_ROWS)],
                f"(c) SimulatedCrash with {done} committed")
    c = walk("c resumed", arima.fit, y, n_chunks - len(done),
             checkpoint_dir=str(dir_c))
    chk.require(_same_walk(a, c), "(c) resumed == (a) bit for bit")
    chk.require(c.meta["journal"]["chunks_resumed"] == len(done),
                f"(c) chunks_resumed {c.meta['journal']['chunks_resumed']}")
    del c

    # (f) OOM backoff: 250,000 -> 125,000 -> 62,500, then the walk stays
    f = walk("f OOM backoff", fi.oom_fit(arima.fit, OOM_ROWS), y, 16)
    events = [e["chunk_rows"] for e in f.meta["oom_events"]]
    chk.require(f.meta["degraded"] and events == [CHUNK_ROWS, CHUNK_ROWS // 2]
                and f.meta["chunk_rows_final"] == CHUNK_ROWS // 4
                and f.meta["chunks_run"] == 16,
                f"(f) two halvings {events}, chunk_rows_final "
                f"{f.meta['chunk_rows_final']}, {f.meta['chunks_run']} chunks")
    f_plain = walk(f"f plain at {CHUNK_ROWS // 4:,}", arima.fit, y, 16,
                   chunk_rows=CHUNK_ROWS // 4)
    chk.require(_same_walk(f, f_plain), "(f) == a plain walk at chunk_rows="
                f"{CHUNK_ROWS // 4:,} bit for bit")
    del f, f_plain

    # (g) a delta walk: rows 500,000-502,499 revised in every column
    y2 = y.clone()
    y2[REVISED[0]:REVISED[1]] = entry.gen_panel(REVISED[1] - REVISED[0],
                                                TIME, seed=7, device=device)
    g = walk("g delta", arima.fit, y2, 1,
             checkpoint_dir=str(CHUNKED_DIR / "g"), delta_from=str(dir_a),
             delta_warmstart=False)
    counts = g.meta["delta"]["counts"]
    chk.require(counts == {"adopted": n_chunks - 1, "warm": 0, "dirty": 1,
                           "new": 0}, f"(g) delta classes {counts}")
    g_cold = walk("g cold", arima.fit, y2, n_chunks)
    chk.require(_same_walk(g, g_cold),
                "(g) delta == the cold walk of the revised panel bit for bit")
    del y2, g, g_cold

    # (h) a write-back sink
    sink_dir = CHUNKED_DIR / "h_sink"
    h = walk("h sink", arima.fit, y, n_chunks,
             checkpoint_dir=str(CHUNKED_DIR / "h"), sink=str(sink_dir))
    parts = sorted(sink_dir.glob("out_*.npz"))
    back = {}
    for key, field in (("params", "params"), ("nll", "neg_log_likelihood"),
                       ("converged", "converged"), ("iters", "iters"),
                       ("status", "status")):
        back[field] = np.concatenate([np.load(p)[key] for p in parts])
    chk.require(h.params is None and len(parts) == n_chunks
                and all(np.array_equal(back[k], getattr(a, k),
                                       equal_nan=back[k].dtype.kind == "f")
                        for k in _FIT_FIELDS),
                f"(h) {len(parts)} sink shards read back == (a) bit for bit")
    del h, back

    # (d) the host-resident walk: the panel leaves the card first
    t0 = time.perf_counter()
    yh = y.cpu().numpy()
    del y
    out["walls_s"]["panel to the host"] = time.perf_counter() - t0
    d = walk("d host-resident", arima.fit, HostChunkSource(yh), n_chunks,
             checkpoint_dir=str(CHUNKED_DIR / "d"))
    staging = d.meta["source"]["staging_pool"]
    pipe_d = d.meta["pipeline"]
    chk.require(_same_walk(a, d), "(d) host-resident == (a) bit for bit")
    chk.require(staging["h2d_bytes"] == yh.nbytes,
                f"(d) h2d_bytes {staging['h2d_bytes']} == the panel's "
                f"{yh.nbytes}")
    peak_a, peak_d = out["peak_gib"]["a in memory"], \
        out["peak_gib"]["d host-resident"]
    chk.require(peak_d < peak_a, f"(d) peak device memory {peak_d:.2f} GiB "
                f"below (a)'s {peak_a:.2f} GiB")
    log(f"  (d) staging pool {staging}; hidden staging "
        f"{pipe_d['hidden_staging_s']} of {pipe_d['staging_wall_s']} s, "
        f"hidden commit {pipe_d['hidden_commit_s']} of "
        f"{pipe_d['commit_wall_s']} s; (a) hidden commit "
        f"{pipe_a['hidden_commit_s']} of {pipe_a['commit_wall_s']} s")

    # (e) npz shards of the first 250,000 rows
    t0 = time.perf_counter()
    npz_dir = CHUNKED_DIR / "e_npz"
    write_npz_shards(str(npz_dir), yh[:NPZ_ROWS], rows_per_shard=NPZ_ROWS)
    out["walls_s"]["npz shards written"] = time.perf_counter() - t0
    e = walk("e npz shards", arima.fit, NpzShardSource(str(npz_dir)), 1)
    chk.require(e.meta["align_mode"] == mode and
                _same_walk(a, e, (0, NPZ_ROWS)),
                "(e) npz walk == (a)'s rows bit for bit")
    del e, yh

    out["overlap"] = {
        "a in memory": {k: pipe_a[k] for k in (
            "commit_wall_s", "hidden_commit_s", "driver_blocked_s",
            "overlap_efficiency", "staging_wall_s", "hidden_staging_s")},
        "d host-resident": {k: pipe_d[k] for k in (
            "commit_wall_s", "hidden_commit_s", "driver_blocked_s",
            "overlap_efficiency", "staging_wall_s", "hidden_staging_s",
            "input_overlap_efficiency")},
        "d staging pool": staging}
    out["phase_s"] = time.perf_counter() - t_phase
    # the journals' manifests stay for inspection; the shards (~1.2 GB)
    # go, so chiprun_out/ stays small
    for p in CHUNKED_DIR.rglob("*.npz"):
        p.unlink()
    log(f"  phase 10 in {out['phase_s']:.1f} s")
    return out


SEARCH_ROWS = 100_000  # 11b's and 11d's stepwise rows
FORECAST_CHUNK = 62_500  # 11e's chunk: 62,500 x 30 x 256 paths a chunk
ENSEMBLE_ROWS = 250_000  # 11e's rows: the cut (PERF.md section 4)
EAGER_ROWS = 10_000  # the eager fused fit and point walk
HORIZON = 30
N_SAMPLES = 256


def _same_arrays(a, b) -> bool:
    import numpy as np

    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind == "f")


def _finite_rel(got, ref) -> float:
    """Max |got - ref| / max(1, max |ref|) over the entries finite in
    both (host arrays); infinite unless both have the same non-finite
    entries (NaN where NaN, the same infinities), as a non-invertible
    fit's forecast overflows on either path."""
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    fin = np.isfinite(ref)
    if got.shape != ref.shape or not np.array_equal(np.isfinite(got), fin) \
            or not np.array_equal(got[~fin], ref[~fin], equal_nan=True):
        return float("inf")
    if not fin.any():
        return 0.0
    return float(np.abs(got[fin] - ref[fin]).max()
                 / max(1.0, np.abs(ref[fin]).max()))


def _same_search(a, b) -> bool:
    return all(_same_arrays(getattr(a, f), getattr(b, f)) for f in (
        "params", "neg_log_likelihood", "converged", "iters", "status",
        "order_index", "criterion"))


def phase_search_forecast(chk: Checks, device) -> dict:
    """Phase 11: the order search (``models.auto.auto_fit``) and the
    forecast walk, ensembles and backtests (``forecasting``) over the
    headline panel, on the CSS, ``hr_moments``, GARCH and EWMA kernels."""
    import shutil
    import tempfile

    import numpy as np

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch import forecasting as fc
    from spark_timeseries_tpu_torch.models import (arima, auto, ewma, garch,
                                                   holtwinters)
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout
    from spark_timeseries_tpu_torch.ops import univariate as uv
    from spark_timeseries_tpu_torch.reliability import (faultinject as fi,
                                                        fit_chunked)

    out = {"walls_s": {}, "launches": {}, "peak_gib": {}}
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_search_"))
    orders = auto.DEFAULT_ORDERS

    def timed(name, fn):
        """``fn()`` with the launch counts set to 0 just before it and read
        just after, and the allocator's peak reset before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            out["walls_s"][name] = time.perf_counter() - t0
            out["launches"][name] = {k: v for k, v in _launches(ck).items()
                                     if v}
            out["peak_gib"][name] = (torch.cuda.max_memory_allocated(device)
                                     / 2**30)
            log(f"  {name}: {out['walls_s'][name]:.3f} s, peak "
                f"{out['peak_gib'][name]:.2f} GiB, launches "
                f"{_route_counts(ck)}")

    try:
        y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
        torch.cuda.synchronize()

        # 11a: the exhaustive fused search of the default grid
        log(f"phase 11a: auto_fit of {len(orders)} orders "
            f"({len(auto.fusion_groups(orders))} fused groups) over the "
            f"{ROWS} x {TIME} headline panel in chunks of {CHUNK_ROWS}")
        root_a = root / "a"
        res_a = timed("11a fused search", lambda: auto.auto_fit(
            y, orders, chunk_rows=CHUNK_ROWS, checkpoint_dir=str(root_a),
            device=device))
        am = res_a.meta["auto_fit"]
        la = out["launches"]["11a fused search"]
        out["selection"] = am["selection_counts"]
        out["diff_cache_hits"] = am["diff_cache_hits"]
        log(f"  selection {am['selection_counts']}; diff_cache_hits "
            f"{am['diff_cache_hits']}")
        chk.require(len(am["fusion_groups"]) == 2
                    and am["diff_cache_hits"] == 4,
                    "11a two fused groups of three orders, four "
                    "differencings saved")
        chk.require(la.get("css_fwd", 0) > 0 and la.get("css_bwd", 0) > 0
                    and la.get("hr_moments", 0) > 0,
                    "11a the CSS kernels and hr_moments ran")
        won = am["selection_counts"]
        chk.require(won["none"] <= ROWS // 1000
                    and won[str((1, 1, 1))] > ROWS // 2,
                    "11a every row but 0.1 % selects; (1,1,1), the panel's "
                    "order, wins most rows")
        chk.require(bool(np.isfinite(res_a.params[res_a.order_index >= 0, :2])
                         .all()), "11a the winners' params are finite")

        # 11b: fused against per order on the first 100,000 rows
        log(f"phase 11b: fuse=1 against fuse='auto' on {SEARCH_ROWS} rows")
        ys = y[:SEARCH_ROWS].contiguous()
        r1 = timed("11b per order", lambda: auto.auto_fit(
            ys, orders, fuse=1, return_criteria=True, device=device))
        rf = timed("11b fused", lambda: auto.auto_fit(
            ys, orders, return_criteria=True, device=device))
        c1, cf = r1.meta["criteria_matrix"], rf.meta["criteria_matrix"]
        agree = r1.order_index == rf.order_index
        flips = np.nonzero(~agree)[0]
        g1, gf = r1.order_index[flips], rf.order_index[flips]
        ok_flip = ((g1 >= 0) & (gf >= 0)).all()
        rel = 0.0
        if flips.size and ok_flip:
            for c in (c1, cf):
                a, b = c[g1, flips], c[gf, flips]
                rel = max(rel, float(np.max(np.abs(a - b)
                                            / np.abs(a).clip(1e-30))))
        dpar = np.abs(r1.params[agree] - rf.params[agree])
        bad_par = ~(dpar <= 1e-2 + 1e-2 * np.abs(rf.params[agree]))
        bad_par &= ~(np.isnan(r1.params[agree]) & np.isnan(rf.params[agree]))
        out["11b"] = {"agree_share": float(agree.mean()),
                      "flips": int(flips.size), "flip_max_rel": rel,
                      "agree_rows_params_outside_1e-2": int(
                          bad_par.any(axis=1).sum())}
        log(f"  11b {out['11b']}")
        chk.require(ok_flip and rel <= 1e-3,
                    "11b every flipped row's two orders are within 1e-3 "
                    "relative under both runs")
        chk.require(not bad_par.any(), "11b agreeing rows' params within "
                    "1e-2 (TestFused's bar)")
        del r1, rf

        # 11c: crash 11a mid-walk, then resume
        log("phase 11c: 11a crashed after five chunk commits, then resumed")
        root_c = root / "c"
        crashed = False
        try:
            timed("11c crashed", lambda: auto.auto_fit(
                y, orders, chunk_rows=CHUNK_ROWS, checkpoint_dir=str(root_c),
                device=device,
                _journal_commit_hook=fi.crash_after_commits(5)))
        except fi.SimulatedCrash:
            crashed = True
        res_c = timed("11c resumed", lambda: auto.auto_fit(
            y, orders, chunk_rows=CHUNK_ROWS, checkpoint_dir=str(root_c),
            device=device))
        chk.require(crashed and _same_search(res_a, res_c),
                    "11c crashed then resumed == 11a bit for bit")
        del res_c

        # 11d: the winners economy and the stepwise search
        log("phase 11d: stage2='winners' on the headline panel, stepwise "
            f"on {SEARCH_ROWS} rows")
        res_w = timed("11d winners", lambda: auto.auto_fit(
            y, orders, stage2="winners", chunk_rows=CHUNK_ROWS,
            device=device))
        wm = res_w.meta["auto_fit"]
        out["11d winners"] = {k: wm[k] for k in (
            "stage1_wall_s", "stage2_wall_s", "stage2_spend_share",
            "selection_counts")}
        log(f"  winners {out['11d winners']}")
        chk.require(sum(o["stage2_rows"] for o in wm["orders"])
                    == ROWS - wm["selection_counts"]["none"],
                    "11d every selected row refit at the full budget")
        del res_w
        res_s = timed("11d stepwise", lambda: auto.auto_fit(
            ys, None, stepwise=True, device=device))
        sm = res_s.meta["auto_fit"]["stepwise"]
        out["11d stepwise"] = {"orders_tried": sm["orders_tried"],
                               "passes": len(sm["passes"]),
                               "converged": sm["converged"],
                               "selection_counts": res_s.meta["auto_fit"][
                                   "selection_counts"]}
        log(f"  stepwise {out['11d stepwise']}")
        chk.require(sm["orders_tried"] >= 4 and (res_s.order_index >= 0)
                    .mean() > 0.999, "11d stepwise selects every row")
        del res_s, ys

        # 11e: the forecast walk with intervals over the search's root
        ne = ENSEMBLE_ROWS
        log(f"phase 11e: ensemble_forecast(auto_root=11a, horizon="
            f"{HORIZON}, temperature=0, intervals, n_samples={N_SAMPLES}) "
            f"over {ne} rows in chunks of {FORECAST_CHUNK}")
        specs, ii, members, _ = fc.load_auto_members(str(root_a))
        if ne < ROWS:  # the cut: the search's member fits of the rows kept
            members = [m._replace(**{f: getattr(m, f)[:ne] for f in (
                "params", "neg_log_likelihood", "converged", "iters",
                "status")}) for m in members]
            src = dict(orders=[sp.order for sp in specs], members=members)
        else:
            src = dict(auto_root=str(root_a))
        ens = timed("11e ensemble", lambda: fc.ensemble_forecast(
            y[:ne], HORIZON, temperature=0.0, intervals=True,
            n_samples=N_SAMPLES, chunk_rows=FORECAST_CHUNK, device=device,
            **src))
        # where a chunk's interval time goes: the draws, the path
        # recursion (one member's sim_fn minus its draws), the band sort
        from spark_timeseries_tpu_torch.forecasting import _prng, kernels
        from spark_timeseries_tpu_torch.forecasting import walk as walk_mod

        yc = y[:FORECAST_CHUNK]
        keys = _prng.fold_in(_prng.PRNGKey(1, device=device),
                             torch.arange(FORECAST_CHUNK, device=device))
        pc = torch.tensor([[0.01, 0.6, 0.3]], device=device).expand(
            FORECAST_CHUNK, 3).contiguous()
        sim = kernels.sim_fn("arima", {"order": entry.ORDER,
                                       "include_intercept": True},
                             HORIZON, N_SAMPLES)
        with torch.no_grad():
            paths = sim(pc, yc, keys)
            out["11e chunk ms"] = {
                "normals": cuda_ms(lambda: _prng.normal(
                    keys, (HORIZON, N_SAMPLES)), reps=2),
                "sim_fn (normals included)": cuda_ms(
                    lambda: sim(pc, yc, keys), reps=2),
                "band sort + quantiles": cuda_ms(
                    lambda: walk_mod._band_quantiles(paths, (0.05, 0.95)),
                    reps=2)}
        del paths
        log(f"  one {FORECAST_CHUNK}-row chunk of (1,1,1) draws "
            f"[{FORECAST_CHUNK}, {HORIZON}, {N_SAMPLES}]: "
            f"{out['11e chunk ms']} (ms)")
        le = out["launches"]["11e ensemble"]
        chk.require(le.get("css_fwd", 0) > 0,
                    "11e the CSS forward (tail and sum modes) ran")
        winner = np.full((ne, HORIZON), np.nan, np.float32)
        for g, spec in enumerate(specs):
            w = fc.forecast_chunked(
                "arima", members[g], y[:ne], HORIZON,
                model_kwargs={"order": spec.order, "include_intercept": ii},
                chunk_rows=FORECAST_CHUNK, device=device)
            sel = ens.order_index == g
            winner[sel] = w.forecast[sel]
        chk.require(_same_arrays(ens.forecast, winner),
                    "11e the ensemble's point forecast == the per-row "
                    "winner's forecast_chunked point forecast bit for bit")
        fin = np.isfinite(ens.lo) & np.isfinite(ens.hi)
        inside = ((ens.lo <= ens.forecast) & (ens.forecast <= ens.hi))[fin]
        out["11e"] = {"finite_share": float(fin.mean()),
                      "point_inside_band_share": float(inside.mean())}
        log(f"  11e {out['11e']}")
        chk.require(fin.mean() > 0.99 and (ens.lo <= ens.hi)[fin].all()
                    and inside.mean() > 0.99,
                    "11e bands finite, lo <= hi, the point inside")
        del ens, winner

        # the plain versions on the card: the fused fit and the point walk
        log(f"phase 11 plain: the fused groups and the point walk on "
            f"{EAGER_ROWS} rows, kernels against backend='eager'")
        ye = y[:EAGER_ROWS].contiguous()
        for members_g in auto.fusion_groups(orders):
            gspecs = tuple((specs[g].order, None) for g in members_g)
            rc = arima.fit_grid(ye, gspecs, backend="cuda", device=device)
            t0 = time.perf_counter()
            re_ = arima.fit_grid(ye, gspecs, backend="eager", device=device)
            torch.cuda.synchronize()
            out["walls_s"][f"eager group {members_g[0]}"] = (
                time.perf_counter() - t0)
            for (o, _), bc, be in zip(gspecs, _grid_blocks(rc, gspecs),
                                      _grid_blocks(re_, gspecs)):
                both = (bc[3] > 0) & (be[3] > 0)
                dconv = abs(float(bc[3].mean()) - float(be[3].mean()))
                # phase 8a's bar on params of order 1; the d = 0 orders'
                # intercept is on the level of an integrated panel, so
                # each difference is taken relative to max(1, |param|)
                delig = int((bc[2] != be[2]).sum())
                if not bool(both.any()):
                    # the bar's median runs over rows converged on both
                    # backends; an MA(1) of an integrated panel converges
                    # on none within the budget, and then on neither
                    conv_c, conv_e = float(bc[3].mean()), float(be[3].mean())
                    log(f"  {o} cuda vs eager: no row converges on both "
                        f"(converged shares {conv_c:.4f} / {conv_e:.4f}), "
                        f"eligibility differs on {delig} rows")
                    chk.require(conv_c == conv_e == 0.0
                                and delig <= EAGER_ROWS // 1000,
                                f"11 fused {o}: no row converges on either "
                                "backend, eligibility equal but on 0.1 %")
                    continue
                pe = be[0][both]
                dpar = (bc[0][both] - pe).abs() / pe.abs().clamp(min=1.0)
                med_dp = float(dpar.median())
                log(f"  {o} cuda vs eager: converged share differs by "
                    f"{dconv:.4f}, median |param diff| / max(1, |param|) "
                    f"{med_dp:.2e} (by column "
                    f"{[f'{v:.1e}' for v in dpar.median(dim=0).values]}, "
                    f"median |param| "
                    f"{[f'{v:.3g}' for v in pe.abs().median(dim=0).values]}"
                    f"), eligibility differs on {delig} rows")
                chk.require(delig <= EAGER_ROWS // 1000 and dconv < 0.02
                            and med_dp < 1e-2,
                            f"11 fused {o} cuda vs eager within phase 8a's "
                            "parity bar")
        for g, spec in enumerate(specs):
            pg = torch.as_tensor(members[g].params[:EAGER_ROWS],
                                 device=device)
            walk_g = fc.forecast_chunked(
                "arima", pg.cpu().numpy(), ye, HORIZON,
                model_kwargs={"order": spec.order}, device=device)
            plain = arima.forecast(pg, ye, spec.order, HORIZON,
                                   backend="eager", device=device)
            rel = _finite_rel(walk_g.forecast, plain.cpu().numpy())
            log(f"  {spec.label} point walk vs eager forecast: rel {rel:.2e}")
            chk.require(rel <= 1e-5, f"11 point walk {spec.label} against "
                        "the eager forecast within 1e-5")
        del ye, members

        # 11h: fault 4, the walk on the caller's stream
        log("phase 11h: 10a's walk (resilient=False) on a side stream")
        plain_walk = timed("11h default stream", lambda: fit_chunked(
            arima.fit, y, chunk_rows=CHUNK_ROWS, resilient=False,
            order=entry.ORDER, device=device,
            checkpoint_dir=str(root / "h_default")))
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))

        def on_side(**kw):
            with torch.cuda.stream(side):
                return fit_chunked(arima.fit, y, chunk_rows=CHUNK_ROWS,
                                   resilient=False, order=entry.ORDER,
                                   device=device, **kw)

        side_walk = timed("11h side stream", lambda: on_side(
            checkpoint_dir=str(root / "h_side")))
        budget_walk = timed("11h side stream, watchdog", lambda: on_side(
            checkpoint_dir=str(root / "h_budget"), chunk_budget_s=600.0))
        chk.require(_same_walk(plain_walk, side_walk)
                    and _same_walk(plain_walk, budget_walk),
                    "11h the side-stream walks (committer, watchdog worker) "
                    "== the default-stream walk bit for bit")
        del plain_walk, side_walk, budget_walk

        # 11g: the backtest campaign, crashed and resumed
        log(f"phase 11g: run_backtest(arima (1,1,1), horizon {HORIZON}, "
            f"4 windows) over the headline panel")
        bt_kw = dict(n_windows=4, model_kwargs={"order": entry.ORDER},
                     device=device)
        bt = timed("11g backtest", lambda: fc.run_backtest(
            y, "arima", HORIZON, checkpoint_dir=str(root / "g"), **bt_kw))
        crashed = False
        try:
            timed("11g crashed", lambda: fc.run_backtest(
                y, "arima", HORIZON, checkpoint_dir=str(root / "g2"),
                _journal_commit_hook=fi.crash_after_commits(2), **bt_kw))
        except fi.SimulatedCrash:
            crashed = True
        bt2 = timed("11g resumed", lambda: fc.run_backtest(
            y, "arima", HORIZON, checkpoint_dir=str(root / "g2"), **bt_kw))
        # where a window's time goes, one piece at a time
        from spark_timeseries_tpu_torch.forecasting import backtest as bt_mod
        from spark_timeseries_tpu_torch.reliability import journal

        parts = {}

        def part(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            parts[name] = time.perf_counter() - t0
            return r

        part("panel digest (once)", lambda: bt_mod._panel_prefix_digest(
            y, TIME))
        part("panel fingerprint (once)",
             lambda: journal.panel_fingerprint(y))
        last = bt.meta["origins"][-1]
        yw = part("window panel copy", lambda: bt_mod._window_panel(y, last))
        wfit = part("window fit walk, journaled", lambda: fit_chunked(
            arima.fit, yw, resilient=False, order=entry.ORDER,
            device=device, checkpoint_dir=str(root / "g_part")))
        wfc = part("window forecast walk", lambda: fc.forecast_chunked(
            "arima", wfit, yw, HORIZON, model_kwargs={"order": entry.ORDER},
            device=device))
        act = part("actuals to the host", lambda: bt_mod._actuals(
            y, last - HORIZON, HORIZON))
        part("metrics on the host", lambda: bt_mod._window_metrics(
            wfc.forecast, None, None, act, 0.9))
        out["11g parts_s"] = parts
        log(f"  11g one window's parts (s): {parts}")
        del yw, wfit, wfc, act
        out["11g"] = {"window_walls_s": [w["wall_s"] for w in bt.windows],
                      "origins": bt.meta["origins"],
                      "mae_h": bt.metrics["mae_h"][:5],
                      "warm": [w["warm_start"] for w in bt.windows],
                      "resumed_classes": bt2.meta["window_classes"]}
        log(f"  11g {out['11g']}")
        chk.require(crashed and bt2.metrics == bt.metrics
                    and [w["digest"] for w in bt2.windows]
                    == [w["digest"] for w in bt.windows],
                    "11g crashed then resumed: metrics bit for bit")
        chk.require(all(w["status"] == "committed" for w in bt.windows)
                    and bt.meta["warm_start"]
                    and all(np.isfinite(bt.metrics["mae_h"])),
                    "11g four windows committed, warm-started, finite MAE")
        del bt, bt2, y

        # 11f: a forecast walk for each other model family
        log("phase 11f: GARCH on the volatility panel, EWMA and additive "
            "Holt-Winters on the hourly panel")
        prices = entry.gen_garch_prices(VOL_ROWS, VOL_TIME, seed=0,
                                        device=device)
        (ret_fp,) = uv.batch_fill_linear_chain(
            layout.fold_panel(100.0 * prices), outputs=("diff",))
        del prices
        returns = layout.unfold_panel(ret_fp)
        del ret_fp
        gfit = garch.fit(returns, device=device)
        gw = timed("11f garch walk", lambda: fc.forecast_chunked(
            "garch", gfit, returns, HORIZON, device=device))
        own = garch.forecast(gfit.params, returns, HORIZON, device=device)
        rel_g = _finite_rel(gw.forecast, own.cpu().numpy())
        chk.require(out["launches"]["11f garch walk"].get("garch_fwd", 0) > 0
                    and rel_g <= 1e-6, f"11f the GARCH walk ran garch_fwd "
                    f"and equals garch.forecast (rel {rel_g:.1e})")
        del returns, gfit, gw, own
        yh = entry.gen_hourly_panel(HOURLY_ROWS, HOURLY_TIME, seed=0,
                                    device=device)
        efit = ewma.fit(yh, device=device)
        ew = timed("11f ewma walk", lambda: fc.forecast_chunked(
            "ewma", efit, yh, 48, chunk_rows=CHUNK_ROWS, device=device))
        own = ewma.forecast(efit.params, yh, 48, device=device)
        rel_e = _finite_rel(ew.forecast, own.cpu().numpy())
        chk.require(out["launches"]["11f ewma walk"].get("ewma_fwd", 0)
                    >= ROWS // CHUNK_ROWS and rel_e <= 1e-6,
                    f"11f the EWMA walk ran ewma_fwd a chunk and equals "
                    f"ewma.forecast (rel {rel_e:.1e})")
        del efit, ew, own
        hfit = holtwinters.fit(yh, SEASON, device=device)
        hw = timed("11f holt-winters walk", lambda: fc.forecast_chunked(
            "holtwinters", hfit, yh, 48, model_kwargs={"period": SEASON},
            chunk_rows=CHUNK_ROWS, device=device))
        own = holtwinters.forecast(hfit.params, yh, SEASON, 48,
                                   device=device)
        rel_h = _finite_rel(hw.forecast, own.cpu().numpy())
        chk.require(rel_h <= 1e-6, f"11f the Holt-Winters walk equals "
                    f"holtwinters.forecast (rel {rel_h:.1e})")
        del yh, hfit, hw, own
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 11 in {out['phase_s']:.1f} s")
    return out


# 12a from_observations: 10^7 observations, cut from 100,000 rows (10^8
# observations, 10.0-13.1 s of host time measured on one H100)
OBS_ROWS = 10_000
# 12a npz round trip: cut from 100,000 rows, whose 400 MB took 20.2 s to
# compress (measured on one H100; PERF.md section 4)
PANEL_NPZ_ROWS = 10_000
COMPAT_ROWS = 100_000  # 12b EWMA / Holt-Winters / GARCH / ARGARCH / AR
SP_FIT_ROWS = 100_000  # 12c time-sharded fits (the autograd cut, PERF.md)
SP_SHARDS = 4  # 12c: the card listed four times along the time axis
# 12c GARCH / ARGARCH: held against the same objective in one time cell
# on 25,000 rows, not against the models' float64 fits, whose plain
# PyTorch recursion took 44.8 + 49.8 s, one step of launches a time step
# (measured on one H100; PERF.md section 4)
SP_GARCH_ROWS = 25_000
# the CPU tests' bars for a time-sharded fit against an unsharded one
# (tests/test_torch_seqparallel.py): params atol on rows both converge
SP_BARS = {"ewma": 1e-4, "garch": 1e-3, "argarch": 2e-3, "arima": 5e-3}


def _dense_garch_rows(b: int, t: int, seed: int, device, ar=None):
    """``[B, T]`` dense GARCH(1,1) returns with ``entry.GARCH_PARAMS``
    (an AR(1) mean ``y_t = c + phi y_{t-1} + r_t`` on top when ``ar`` is
    ``(c, phi)``), built time-major on the card; the time-sharded fits
    take dense panels."""
    from spark_timeseries_tpu_torch import entry

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    omega, alpha, beta = entry.GARCH_PARAMS
    z = torch.randn(t, b, generator=gen, device=device)
    h = torch.full((b,), omega / (1.0 - alpha - beta), device=device)
    out = torch.empty_like(z)
    prev = torch.zeros(b, device=device)
    for i in range(t):
        r = h.sqrt() * z[i]
        h = omega + alpha * r * r + beta * h
        prev = r if ar is None else ar[0] + ar[1] * prev + r
        out[i] = prev
    return out.t().contiguous()


def _share_within(got, want, bar: float) -> tuple:
    """(share of rows both fits converged, share of those rows whose
    params agree within ``bar``, max |param diff| over them)."""
    both = got.converged & want.converged
    d = (got.params - want.params).abs().amax(1)[both]
    n = max(int(both.sum()), 1)
    return (float(both.float().mean()), float((d <= bar).sum()) / n,
            float(d.max()) if d.numel() else 0.0)


def phase_panel_mesh(chk: Checks, device) -> dict:
    """Phase 12: the panel API (``TimeSeriesPanel``), the upstream-shaped
    ``compat.sparkts`` and the single-process mesh with the time-sharded
    functions and fits (``parallel.mesh``, ``ops.seqparallel``)."""
    import functools
    import shutil
    import tempfile

    import numpy as np

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch import forecasting as fc
    from spark_timeseries_tpu_torch import index as dtix
    from spark_timeseries_tpu_torch import panel as panellib
    from spark_timeseries_tpu_torch.compat import sparkts
    from spark_timeseries_tpu_torch.models import (arima, autoregression,
                                                   ewma, garch, holtwinters)
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.ops import layout
    from spark_timeseries_tpu_torch.ops import seqparallel as sp
    from spark_timeseries_tpu_torch.ops import univariate as uv
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib
    from spark_timeseries_tpu_torch.reliability import fit_chunked

    out = {"walls_s": {}, "launches": {}, "peak_gib": {}}
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_panel_"))

    def timed(name, fn):
        """``fn()`` with the launch counts set to 0 just before it and read
        just after, and the allocator's peak reset before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            torch.cuda.synchronize()
            out["walls_s"][name] = time.perf_counter() - t0
            out["launches"][name] = {k: v for k, v in ck.LAUNCHES.items()
                                     if v}
            out["peak_gib"][name] = (torch.cuda.max_memory_allocated(device)
                                     / 2**30)
            log(f"  {name}: {out['walls_s'][name]:.3f} s, peak "
                f"{out['peak_gib'][name]:.2f} GiB, launches "
                f"{out['launches'][name]}")

    def ran(name, *kernels):
        la = out["launches"][name]
        chk.require(all(la.get(k, 0) > 0 for k in kernels),
                    f"{name}: {', '.join(kernels)} launched ({la})")

    try:
        y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
        idx = dtix.uniform("2000-01-03", TIME, dtix.DayFrequency(1))
        keys = np.arange(ROWS)
        torch.cuda.synchronize()

        # 12a: the panel on the headline panel
        log(f"phase 12a: TimeSeriesPanel over the {ROWS} x {TIME} headline "
            "panel")
        p = timed("12a construct", lambda: panellib.TimeSeriesPanel(
            idx, keys, y))
        chk.require(p.values is y and p.n_series == ROWS,
                    "12a the constructor takes the tensor without a copy")
        filled = timed("12a fill linear", lambda: p.fill("linear"))
        chk.require(out["launches"]["12a fill linear"] == {"fill_chain": 1},
                    "12a fill('linear') is one fill_chain launch")
        chk.require(same_bits(filled.values, uv.batch_fill("linear")(y)),
                    "12a fill('linear') == uv.batch_fill('linear') bit for "
                    "bit")
        del filled
        acf = timed("12a autocorr(20)", lambda: p.autocorr(20))
        ran("12a autocorr(20)", "autocorr")
        chk.require(same_bits(acf, uv.batch_autocorr(20)(y)),
                    "12a autocorr(20) == uv.batch_autocorr(20) bit for bit")
        del acf
        walk = dict(order=entry.ORDER, chunk_rows=CHUNK_ROWS)
        pfit = timed("12a panel.fit", lambda: p.fit(
            "arima", checkpoint_dir=str(root / "fit_panel"), **walk))
        dfit = timed("12a fit_chunked", lambda: fit_chunked(
            arima.fit, y, checkpoint_dir=str(root / "fit_direct"),
            device=device, **walk))
        chk.require(_same_walk(pfit, dfit), "12a panel.fit == fit_chunked "
                    "with the same knobs, bit for bit")
        chk.require(out["launches"]["12a panel.fit"]
                    == out["launches"]["12a fit_chunked"]
                    and out["launches"]["12a panel.fit"].get(
                        "hr_moments", 0) == 2 * (ROWS // CHUNK_ROWS),
                    "12a panel.fit launches what the chunk walk launches")
        del dfit
        pfc = timed("12a panel.forecast", lambda: p.forecast(
            "arima", 30, pfit, order=entry.ORDER, chunk_rows=CHUNK_ROWS))
        dfc = fc.forecast_chunked("arima", pfit, y, 30,
                                  model_kwargs={"order": entry.ORDER},
                                  chunk_rows=CHUNK_ROWS, device=device)
        ran("12a panel.forecast", "css_fwd")
        chk.require(_same_arrays(pfc.forecast, dfc.forecast)
                    and _same_arrays(pfc.status, dfc.status),
                    "12a panel.forecast == forecast_chunked bit for bit")
        chk.require(bool(np.isfinite(pfc.forecast).mean() > 0.99),
                    "12a the forecast is finite")
        del pfc, dfc
        d = timed("12a differences", lambda: p.differences(1))
        chk.require(same_bits(d.values, uv.differences_at_lag(y, 1)),
                    "12a differences(1) == uv.differences_at_lag")
        del d
        st = timed("12a series_stats", p.series_stats)
        chk.require(bool((st["count"] == TIME).all())
                    and bool(torch.isfinite(st["stdev"]).all()),
                    "12a series_stats: full counts, finite stdev")
        del st
        _, inst = timed("12a to_instants", p.to_instants)
        chk.require(tuple(inst.shape) == (TIME, ROWS)
                    and torch.equal(inst[:, ROWS // 3], y[ROWS // 3]),
                    "12a to_instants is the transpose")
        del inst
        lo, hi = TIME // 10, TIME - TIME // 10  # the index starts 2 days in
        sub = timed("12a islice/select/with_index", lambda: p.islice(
            lo, hi).select(list(range(0, ROWS, 1000))).with_index(
                dtix.uniform("2000-01-01", TIME, dtix.DayFrequency(1))))
        chk.require(sub.n_series == ROWS // 1000 and sub.n_time == TIME
                    and torch.equal(sub.values[1, lo + 2:hi + 2],
                                    y[1000, lo:hi])
                    and bool(torch.isnan(sub.values[:, :lo + 2]).all()),
                    "12a islice / select / with_index move the right values")
        del sub
        small = panellib.TimeSeriesPanel(idx, keys[:PANEL_NPZ_ROWS],
                                         y[:PANEL_NPZ_ROWS])
        path = str(root / "panel.npz")
        timed(f"12a npz save {PANEL_NPZ_ROWS} rows", lambda: small.save(path))
        back = timed(f"12a npz load {PANEL_NPZ_ROWS} rows",
                     lambda: panellib.TimeSeriesPanel.load(path,
                                                           device=device))
        chk.require(same_bits(back.values, small.values)
                    and back.keys.tolist() == [str(k) for k in
                                               keys[:PANEL_NPZ_ROWS]]
                    and back.index == idx,
                    "12a npz round trip bit-exact")
        del small, back
        t0 = time.perf_counter()
        host = y[:OBS_ROWS].cpu().numpy()
        obs_keys = np.repeat(np.arange(OBS_ROWS), TIME)
        obs_ts = np.tile(idx.datetimes(), OBS_ROWS)
        out["walls_s"]["12a observations to the host"] = (
            time.perf_counter() - t0)
        po = timed(f"12a from_observations {OBS_ROWS} x {TIME}",
                   lambda: panellib.from_observations(
                       idx, obs_keys, obs_ts, host.reshape(-1),
                       device=device))
        chk.require(po.keys.tolist() == list(range(OBS_ROWS))
                    and same_bits(po.values, y[:OBS_ROWS]),
                    "12a from_observations == the panel's rows, bit for bit")
        del po, host, obs_keys, obs_ts

        # 12b: compat
        log("phase 12b: compat.sparkts on the headline panel and on "
            f"{COMPAT_ROWS}-row volatility and hourly panels")
        cm = timed("12b ARIMA.fit_model", lambda: sparkts.ARIMA.fit_model(
            1, 1, 1, y))
        ran("12b ARIMA.fit_model", "css_fwd", "css_bwd", "hr_moments")
        direct = arima.fit(y, entry.ORDER, method="css-cgd", device=device)
        chk.require(same_bits(cm.params, direct.params),
                    "12b ARIMA.fit_model == arima.fit bit for bit")
        del direct
        cj = timed("12b ARIMA.fit_model journaled",
                   lambda: sparkts.ARIMA.fit_model(
                       1, 1, 1, y, checkpoint_dir=str(root / "compat_j"),
                       chunk_rows=CHUNK_ROWS))
        jw = fit_chunked(functools.partial(
            arima.fit, order=entry.ORDER, include_intercept=True,
            method="css-cgd", init_params=None), y, chunk_rows=CHUNK_ROWS,
            resilient=False, checkpoint_dir=str(root / "compat_d"),
            device=device)
        chk.require(_same_arrays(cj.coefficients, jw.params),
                    "12b journaled ARIMA.fit_model == fit_chunked bit for "
                    "bit")
        del cj, jw
        cfp = timed("12b forecast_panel", lambda: cm.forecast_panel(
            y, 30, chunk_rows=CHUNK_ROWS))
        dfp = fc.forecast_chunked(
            "arima", cm.coefficients, y, 30,
            model_kwargs={"order": entry.ORDER, "include_intercept": True},
            chunk_rows=CHUNK_ROWS, device=device)
        chk.require(_same_arrays(cfp.forecast, dfp.forecast),
                    "12b forecast_panel == forecast_chunked bit for bit")
        del cfp, dfp
        rdd = sparkts.TimeSeriesRDD(p)
        std = timed("12b map_series(mode='device') over the headline panel",
                    lambda: rdd.map_series(
                        lambda v: (v - v.mean()) / v.std(), mode="device"))
        plain = (y - y.mean(1, keepdim=True)) / y.std(1, keepdim=True)
        err, rel = rel_err(std.panel.values, plain)
        chk.require(rel <= 1e-6, f"12b map_series(mode='device') == the "
                    f"panel-wide standardization (rel {rel:.1e})")
        del std, plain, rdd
        ar_m = timed("12b Autoregression.fit_model",
                     lambda: sparkts.Autoregression.fit_model(
                         y[:COMPAT_ROWS], max_lag=2))
        chk.require(same_bits(ar_m.params, autoregression.fit(
            y[:COMPAT_ROWS], 2, device=device).params),
            "12b Autoregression.fit_model == autoregression.fit bit for bit")
        prices = entry.gen_garch_prices(COMPAT_ROWS, VOL_TIME, seed=0,
                                        device=device)
        (ret_fp,) = uv.batch_fill_linear_chain(
            layout.fold_panel(100.0 * prices), outputs=("diff",))
        returns = layout.unfold_panel(ret_fp)
        del prices, ret_fp
        g_m = timed("12b GARCH.fit_model",
                    lambda: sparkts.GARCH.fit_model(returns))
        ran("12b GARCH.fit_model", "garch_fwd", "garch_bwd")
        chk.require(same_bits(g_m.params, garch.fit(returns,
                                                    device=device).params),
                    "12b GARCH.fit_model == garch.fit bit for bit")
        ag_m = timed("12b ARGARCH.fit_model",
                     lambda: sparkts.ARGARCH.fit_model(returns))
        ran("12b ARGARCH.fit_model", "garch_fwd", "garch_bwd")
        chk.require(same_bits(ag_m.params, garch.fit_argarch(
            returns, device=device).params),
            "12b ARGARCH.fit_model == garch.fit_argarch bit for bit")
        del returns
        yh = entry.gen_hourly_panel(COMPAT_ROWS, HOURLY_TIME, seed=0,
                                    device=device)
        e_m = timed("12b EWMA.fit_model", lambda: sparkts.EWMA.fit_model(yh))
        ran("12b EWMA.fit_model", "ewma_fwd", "ewma_bwd")
        chk.require(same_bits(e_m.params, ewma.fit(yh, device=device).params),
                    "12b EWMA.fit_model == ewma.fit bit for bit")
        h_m = timed("12b HoltWinters.fit_model",
                    lambda: sparkts.HoltWinters.fit_model(yh, SEASON))
        ran("12b HoltWinters.fit_model", "hw_fwd", "hw_bwd")
        chk.require(same_bits(h_m.params, holtwinters.fit(
            yh, SEASON, device=device).params),
            "12b HoltWinters.fit_model == holtwinters.fit bit for bit")
        ok = True
        for name, m in (("arima", cm), ("ar", ar_m), ("garch", g_m),
                        ("argarch", ag_m), ("ewma", e_m), ("hw", h_m)):
            mp = str(root / f"model_{name}.npz")
            m.save(mp)
            back = sparkts.load_model(mp, device=device)
            ok &= type(back) is type(m) and same_bits(back.params, m.params)
        chk.require(ok, "12b save -> load_model round trips every model "
                    "bit for bit")
        del cm, ar_m, g_m, ag_m, e_m, h_m

        # 12c: the mesh
        log(f"phase 12c: default_mesh() and a (1, {SP_SHARDS}) mesh of the "
            "card")
        m1 = meshlib.default_mesh()
        chk.require(m1.shape == {"series": torch.cuda.device_count()}
                    and m1.devices.flat[0] == device,
                    f"12c default_mesh() lists the card ({m1})")
        if m1.shape["series"] == 1:
            pm = panellib.TimeSeriesPanel(idx, keys, y, mesh=m1)
            chk.require(pm.values is y and same_bits(
                pm.differences(1).values, uv.differences_at_lag(y, 1)),
                "12c a panel on default_mesh() == the unsharded panel")
            del pm
        m4 = meshlib.default_mesh(devices=[device] * SP_SHARDS,
                                  time_shards=SP_SHARDS)
        mom = timed("12c sp_moments", lambda: sp.sp_moments_sharded(m4, y))
        mean = y.mean(1)
        chk.require(bool((mom["count"] == TIME).all())
                    and rel_err(mom["mean"], mean)[1] <= 1e-5
                    and rel_err(mom["var"], y.var(1))[1] <= 1e-5,
                    "12c sp_moments == the unsharded moments (1e-5)")
        del mom, mean
        sac = timed("12c sp_autocorr(20)",
                    lambda: sp.sp_autocorr_sharded(m4, y, 20))
        # two float32 summation orders over T terms: 1e-4 of r_k
        err = float((sac - uv.batch_autocorr(20)(y)).abs().max())
        chk.require(err <= 1e-4, f"12c sp_autocorr == the autocorrelation "
                    f"kernel (max abs {err:.1e})")
        del sac
        scs = timed("12c sp_cumsum", lambda: sp.sp_cumsum_sharded(m4, y))
        err, rel = rel_err(scs, torch.cumsum(y, 1))
        chk.require(rel <= 1e-5, f"12c sp_cumsum == cumsum (rel {rel:.1e})")
        del scs
        sdf = timed("12c sp_differences", lambda: sp.sp_differences_sharded(
            m4, y, 1))
        chk.require(same_bits(sdf, uv.differences_at_lag(y, 1)),
                    "12c sp_differences == differences_at_lag bit for bit")
        del sdf
        for what, panel_ in (("headline", y), ("hourly", yh)):
            chain = timed(f"12c sp_fill_linear_chain {what}",
                          lambda: sp.sp_fill_linear_chain_sharded(m4,
                                                                  panel_))
            want = uv.batch_fill_linear_chain(panel_)
            worst = max(rel_err(a, b)[1] for a, b in zip(chain, want))
            chk.require(worst <= 1e-6, f"12c sp_fill_linear_chain on the "
                        f"{what} panel == the fill-chain kernel (rel "
                        f"{worst:.1e})")
            del chain, want
        alpha = torch.rand(ROWS, generator=torch.Generator(
            device=device).manual_seed(12), device=device) * 0.9 + 0.05
        ssm = timed("12c sp_ewma_smooth", lambda: sp.sp_ewma_smooth_sharded(
            m4, y, alpha))
        err, rel = rel_err(ssm, ewma.smooth(alpha, y))
        chk.require(rel <= 1e-5, f"12c sp_ewma_smooth == ewma.smooth (rel "
                    f"{rel:.1e})")
        del ssm, alpha, yh

        # float64, as the CPU tests fit: their bars are float64 optimizer
        # tolerances (float32's default tol of 1e-4 leaves stop points
        # further apart than they are); the unsharded float64 fits run the
        # models' plain PyTorch path, the kernels being float32 only
        n, ng = SP_FIT_ROWS, SP_GARCH_ROWS
        m1cell = meshlib.default_mesh(devices=[device])
        log(f"phase 12c: time-sharded fits on {n} float64 rows ({ng} for "
            f"the GARCH pair), (1, {SP_SHARDS}) mesh, against the unsharded "
            "fits (the GARCH pair: the same objective in one time cell)")
        gen = torch.Generator(device=device).manual_seed(13)
        level = (100.0 + (0.5 * torch.randn(n, TIME, generator=gen,
                                            device=device)).cumsum(1)
                 + torch.randn(n, TIME, generator=gen, device=device)
                 ).double()
        rg = _dense_garch_rows(ng, TIME, 14, device).double()
        ya = _dense_garch_rows(ng, TIME, 15, device, ar=(0.05, 0.4)).double()
        yd = y[:n].double()
        fits = (("ewma", lambda: sp.sp_ewma_fit(m4, level),
                 lambda: ewma.fit(level, device=device)),
                ("garch", lambda: sp.sp_garch_fit(m4, rg),
                 lambda: sp.sp_garch_fit(m1cell, rg)),
                ("argarch", lambda: sp.sp_argarch_fit(m4, ya),
                 lambda: sp.sp_argarch_fit(m1cell, ya)),
                ("arima", lambda: sp.sp_arima_fit(m4, yd, entry.ORDER),
                 lambda: arima.fit(yd, entry.ORDER, device=device)))
        out["12c fits"] = {}
        for name, sharded, flat in fits:
            got = timed(f"12c sp_{name}_fit", sharded)
            want = timed(f"12c {name} unsharded fit", flat)
            both, within, worst = _share_within(got, want, SP_BARS[name])
            out["12c fits"][name] = {
                "both_converged": both, "within_bar_share": within,
                "max_abs_param_diff": worst, "bar": SP_BARS[name]}
            log(f"  {name}: both converged {both:.4f}, within "
                f"{SP_BARS[name]:g} {within:.5f}, max |diff| {worst:.2e}")
            chk.require(both >= 0.7 and within == 1.0,
                        f"12c sp_{name}_fit: >= 70 % of rows converge on "
                        "both, all of those within the CPU tests' bar")
            del got, want
        del level, rg, ya, yd
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 in {out['phase_s']:.1f} s")
    return out


LANE_CHUNK = 125_000  # 13a: four lanes x two chunks of the headline panel
SLOW_CHUNK = 62_500  # 13a slow_lane: four chunks a lane, room to steal
SLOW_DELAY_S = 3.0  # 13a slow_lane: the straggler's stall before each chunk
SERVE_TENANTS, SERVE_ROWS = 8, 32_768  # 13b: the tenants' ragged panels
SERVE_CELL = 32_768  # 13b: the batcher's cell, one tenant a chunk
SERVE_MAX_BATCH, SERVE_MAX_QUEUE = 65_536, 262_144
AUTO_ROWS = 8_192  # 13b: the auto request's rows
KILL_ROWS, KILL_IDS = 8_192, ("kill-0", "kill-1", "kill-2")  # 13b children
TICK_ROWS, TICK_CHUNK, TICKS, TICK_CYCLES = 100_000, 50_000, 24, 3  # 13c
BACKTEST_ROWS = 10_000  # 13c
LANE_DIR = (Path(__file__).resolve().parent / "chiprun_out"
            / "chip_smoke_lanes")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gib(device, reset: bool = False) -> float:
    if torch.device(device).type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(device)
        return 0.0
    return torch.cuda.max_memory_allocated(device) / 2**30


def _tenant_rows(rows: int, seed: int, device):
    """``[rows, TIME]`` ragged host rows for one tenant: the headline
    recursion, every seventh row starting late and every eleventh ending
    three steps early (so every tenant panel aligns in the general mode and
    all of them share one batch key)."""
    from spark_timeseries_tpu_torch import entry

    y = entry.gen_panel(rows, TIME, seed=seed, device=device).cpu().numpy()
    y[::7, :40] = float("nan")
    y[::11, -3:] = float("nan")
    return y


def _kill_server(root: str, device, hook=None):
    from spark_timeseries_tpu_torch import serving

    return serving.FitServer(root, cell_rows=KILL_ROWS,
                             max_batch_rows=SERVE_MAX_BATCH,
                             max_queue_rows=SERVE_MAX_QUEUE, autotune=False,
                             device=device, _commit_hook=hook)


def _kill_requests(srv, device):
    from spark_timeseries_tpu_torch import entry

    return [srv.submit(f"k{i}", _tenant_rows(KILL_ROWS, 300 + i, device),
                       "arima", request_id=rid, order=list(entry.ORDER))
            for i, rid in enumerate(KILL_IDS)]


def serve_child(mode: str, root: str, out: str = "") -> int:
    """13b's crash-recovery children: ``run`` serves three requests and
    dies by SIGKILL inside its batch walk, mid-commit after two shard
    writes; ``recover`` restarts on the root, waits for every request to
    be re-answered and saves the results to ``out``."""
    import numpy as np

    from spark_timeseries_tpu_torch.reliability import faultinject as fi

    device = torch.device("cuda", 0)
    if mode == "run":
        srv = _kill_server(root, device,
                           fi.server_kill(2, mid_commit=True))
        tickets = _kill_requests(srv, device)
        srv.start()
        for t in tickets:
            t.result(timeout=300)
        print("the server outlived its SIGKILL", file=sys.stderr)
        return 1
    srv = _kill_server(root, device)
    srv.start()
    got, deadline = {}, time.monotonic() + 240
    while len(got) < len(KILL_IDS) and time.monotonic() < deadline:
        for rid in KILL_IDS:
            try:
                got[rid] = srv.result_for(rid)
            except KeyError:
                pass
        time.sleep(0.05)
    srv.stop(timeout_s=120)
    np.savez(out, **{f"{rid}__{f}": np.asarray(getattr(r, f))
                     for rid, r in got.items() for f in _FIT_FIELDS},
             **{f"{rid}__resumed": np.asarray(
                 r.meta["journal"]["chunks_resumed"])
                for rid, r in got.items()})
    print(json.dumps(srv.health()["counters"]))
    return 0 if len(got) == len(KILL_IDS) else 1


def phase_lanes_serving(chk: Checks, device) -> dict:
    """Phase 13: the multi-lane chunk walk (a series mesh listing the card
    four times, elastic lanes under lane faults, crash and resume) and the
    in-process serving loop (``serving.FitServer``: eight tenants at once,
    a forecast, a warm-routed auto request, a deadline, SIGKILL recovery in
    child processes, the tick loop and a served backtest)."""
    import shutil
    import tempfile

    import numpy as np

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch import forecasting as fc
    from spark_timeseries_tpu_torch import serving
    from spark_timeseries_tpu_torch.models import arima
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.parallel import mesh as meshlib
    from spark_timeseries_tpu_torch.reliability import (faultinject as fi,
                                                        fit_chunked,
                                                        source as source_mod)
    from spark_timeseries_tpu_torch.reliability.status import FitStatus

    out = {"walls_s": {}, "launches": {}, "peak_gib": {}}
    t_phase = time.perf_counter()
    shutil.rmtree(LANE_DIR, ignore_errors=True)
    LANE_DIR.mkdir(parents=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_serving_"))
    kernels3 = ("css_fwd", "css_bwd", "hr_moments")

    def counted(name, fn):
        """``fn()`` with the launch counts set to 0 just before it and
        read just after, its wall and the allocator's peak."""
        _sync(device)
        _peak_gib(device, reset=True)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            _sync(device)
            out["walls_s"][name] = time.perf_counter() - t0
            out["launches"][name] = {k: ck.LAUNCHES[k] for k in kernels3}
            out["peak_gib"][name] = _peak_gib(device)
            log(f"  {name}: {out['walls_s'][name]:.3f} s, launches "
                f"{out['launches'][name]}, peak "
                f"{out['peak_gib'][name]:.2f} GiB")

    def walk(name, fit, panel, **kw):
        kw.setdefault("chunk_rows", LANE_CHUNK)
        return counted(name, lambda: fit_chunked(
            fit, panel, resilient=False, order=entry.ORDER, device=device,
            **kw))

    def kernels_ran(name, fits):
        la = out["launches"][name]
        chk.require(la["hr_moments"] == 2 * fits and la["css_fwd"] > 0
                    and la["css_bwd"] > 0,
                    f"{name}: hr_moments launched 2 x {fits} chunk fits, "
                    "the CSS kernels ran (no eager chunk)")

    try:
        # -- 13a: the multi-lane walk ----------------------------------------
        mesh = meshlib.default_mesh(devices=[device] * 4)
        n_chunks = ROWS // LANE_CHUNK
        log(f"phase 13a: multi-lane walk, ARIMA(1,1,1) on {ROWS} x {TIME}, "
            f"a series mesh listing {device} four times, chunks of "
            f"{LANE_CHUNK}")
        y = entry.gen_panel(ROWS, TIME, seed=0, device=device)
        _sync(device)
        one = walk("13a one lane", arima.fit, y)
        kernels_ran("13a one lane", n_chunks)
        lanes = walk("13a four lanes", arima.fit, y, mesh=mesh,
                     checkpoint_dir=str(LANE_DIR / "plain"))
        man = json.loads((LANE_DIR / "plain" / "manifest.json").read_text())
        chk.require(_same_walk(one, lanes), "13a four lanes == one lane, "
                    "bit for bit")
        chk.require(man["merged_from_shards"] == 4
                    and len(man["chunks"]) == n_chunks
                    and all(c["status"] == "committed"
                            for c in man["chunks"]),
                    f"13a merged manifest: merged_from_shards "
                    f"{man['merged_from_shards']}, {len(man['chunks'])} "
                    "committed chunks")
        chk.require(out["launches"]["13a four lanes"]
                    == out["launches"]["13a one lane"],
                    "13a four lanes launch what one lane launches")
        el = lanes.meta["shards"]["elastic"]
        chk.require(el["quarantined"] == [] and el["lane_retries_used"] == 0,
                    "13a no quarantine or retry on the healthy walk")
        out["shards"] = lanes.meta["shards"]
        log(f"  meta['shards'] {json.dumps(lanes.meta['shards'])}")

        killed = walk("13a lane_kill(1, after 1)",
                      fi.lane_kill(arima.fit, 1, after_chunks=1), y,
                      mesh=mesh, checkpoint_dir=str(LANE_DIR / "kill"),
                      lane_retry_backoff_s=0.01)
        ek = killed.meta["shards"]["elastic"]
        chk.require(_same_walk(one, killed), "13a lane_kill == one lane, "
                    "bit for bit")
        chk.require([q["shard_id"] for q in ek["quarantined"]] == [1]
                    and ek["reassigned_spans"] >= 1,
                    f"13a lane_kill: quarantined "
                    f"{[q['shard_id'] for q in ek['quarantined']]}, "
                    f"reassigned spans {ek['reassigned_spans']}")
        chk.require(out["launches"]["13a lane_kill(1, after 1)"]
                    == out["launches"]["13a one lane"],
                    "13a lane_kill launches what one lane launches (the "
                    "dead lane's committed chunk adopted, not refitted)")
        out["elastic_kill"] = ek

        one62 = walk(f"13a one lane at {SLOW_CHUNK:,}", arima.fit, y,
                     chunk_rows=SLOW_CHUNK)
        slow_name = f"13a slow_lane(2, {SLOW_DELAY_S} s)"
        slow = walk(slow_name,
                    fi.slow_lane(arima.fit, 2, SLOW_DELAY_S), y, mesh=mesh,
                    chunk_rows=SLOW_CHUNK, rebalance_threshold=2.0)
        es = slow.meta["shards"]["elastic"]
        chk.require(_same_walk(one62, slow), "13a slow_lane == one lane at "
                    f"{SLOW_CHUNK:,}, bit for bit")
        chk.require(es["steals"] >= 1 and es["quarantined"] == [],
                    f"13a slow_lane: {es['steals']} steals, no quarantine")
        chk.require(out["launches"][slow_name]
                    == out["launches"][f"13a one lane at {SLOW_CHUNK:,}"],
                    "13a slow_lane launches what one lane launches")
        out["elastic_slow"] = es
        del one62, slow

        crashed = False
        try:
            walk("13a crashed", arima.fit, y, mesh=mesh,
                 checkpoint_dir=str(LANE_DIR / "crash"),
                 _journal_commit_hook=fi.crash_after_commits(3))
        except fi.SimulatedCrash:
            crashed = True
        resumed = walk("13a resumed", arima.fit, y, mesh=mesh,
                       checkpoint_dir=str(LANE_DIR / "crash"))
        n_res = resumed.meta["journal"]["chunks_resumed"]
        chk.require(crashed and n_res >= 3, f"13a crash after 3 commits, "
                    f"{n_res} chunks resumed")
        chk.require(_same_walk(one, resumed), "13a resumed == one lane, "
                    "bit for bit")
        chk.require(resumed.meta["shards"]["elastic"]["quarantined"] == [],
                    "13a no quarantine on the resume")
        kernels_ran("13a resumed", n_chunks - n_res)
        out["lane_walls_s"] = {
            "one lane": out["walls_s"]["13a one lane"],
            "four lanes": out["walls_s"]["13a four lanes"]}
        log(f"  13a walls: one lane {out['walls_s']['13a one lane']:.3f} s, "
            f"four lanes {out['walls_s']['13a four lanes']:.3f} s")
        del y, one, lanes, killed, resumed

        # -- 13b: the serving loop -------------------------------------------
        log(f"phase 13b: FitServer on {device}: {SERVE_TENANTS} tenants x "
            f"{SERVE_ROWS} x {TIME} ragged rows from {SERVE_TENANTS} threads, "
            f"cell {SERVE_CELL}, max_batch_rows {SERVE_MAX_BATCH}")
        tenants = [_tenant_rows(SERVE_ROWS, 100 + i, device)
                   for i in range(SERVE_TENANTS)]
        srv = serving.FitServer(
            str(tmp / "srv"), cell_rows=SERVE_CELL,
            max_batch_rows=SERVE_MAX_BATCH, max_queue_rows=SERVE_MAX_QUEUE,
            autotune=False, device=device)
        kw = {"order": list(entry.ORDER)}
        calls = [((f"t{i}", v, "arima"), kw) for i, v in enumerate(tenants)]

        def storm():
            # every tenant is admitted before the serve loop starts, so the
            # batches are pairs whatever the disk's write-ahead speed
            tickets, errors = fi.request_storm(srv.submit, calls,
                                               threads=SERVE_TENANTS)
            chk.require(not any(errors), f"13b every submit admitted "
                        f"({[repr(e)[:80] for e in errors if e]})")
            srv.start()
            return [t.result(timeout=600) for t in tickets if t is not None]

        served = counted("13b fit requests", storm)
        kernels_ran("13b fit requests", SERVE_TENANTS)
        # phase 14 holds its wired tenants to these answers and launches
        out["_handoff"] = {"served": served,
                           "launches": out["launches"]["13b fit requests"],
                           "wall": out["walls_s"]["13b fit requests"]}
        chk.require(len(served) == SERVE_TENANTS and max(
            r.meta["batch_members"] for r in served) == 2,
            "13b eight tenants answered in two-member batches")
        direct = [fit_chunked(arima.fit, torch.as_tensor(v, device=device),
                              chunk_rows=SERVE_CELL, resilient=False,
                              align_mode="general", order=entry.ORDER,
                              device=device) for v in tenants]
        chk.require(all(_same_walk(d, r) for d, r in zip(direct, served)),
                    "13b every tenant == its rows walked alone, bit for bit")
        with serving.FitServer(str(tmp / "solo"), cell_rows=SERVE_CELL,
                               autotune=False, device=device) as solo:
            s0 = solo.submit("t0", tenants[0], "arima",
                             **kw).result(timeout=600)
        chk.require(_same_walk(s0, served[0]), "13b tenant 0 batched == "
                    "its solo request, bit for bit")
        shutil.rmtree(tmp / "solo", ignore_errors=True)

        def forecast():
            return fc.as_result(srv.submit_forecast(
                "t0", tenants[0], served[0], model="arima", horizon=HORIZON,
                model_kwargs={"order": entry.ORDER}).result(timeout=600),
                HORIZON, False)

        f0 = counted("13b forecast request", forecast)
        local = fc.forecast_chunked(
            "arima", served[0], torch.as_tensor(tenants[0], device=device),
            HORIZON, model_kwargs={"order": entry.ORDER}, device=device)
        chk.require(np.array_equal(f0.forecast, local.forecast,
                                   equal_nan=True)
                    and out["launches"]["13b forecast request"]["css_fwd"]
                    > 0, "13b served forecast == the local forecast walk, "
                    "bit for bit, on the CSS kernels")
        y_auto = tenants[1][:AUTO_ROWS]
        routes = []
        for k in range(2):
            r = counted(f"13b auto request {k + 1}", lambda: srv.submit(
                "auto", y_auto, "panel_auto",
                warm_routing=True).result(timeout=600))
            routes.append(r.meta["auto"]["route"])
            chk.require(out["launches"][f"13b auto request {k + 1}"]
                        ["css_fwd"] > 0, f"13b auto request {k + 1} ran "
                        "the CSS kernels")
        chk.require(routes == ["new", "stable"], f"13b auto routes {routes}")
        late = counted("13b tight deadline", lambda: srv.submit(
            "late", tenants[2][:1024], "arima", deadline_s=1e-4,
            **kw).result(timeout=600))
        chk.require(bool((late.status == FitStatus.TIMEOUT).all()),
                    "13b the tight deadline came back all TIMEOUT rows")

        # -- 13c: a served backtest -------------------------------------------
        yb = entry.gen_panel(BACKTEST_ROWS, TIME, seed=31, device=device)
        bt_kw = dict(model_kwargs={"order": entry.ORDER}, device=device)
        bt_local = counted("13c backtest local", lambda: fc.run_backtest(
            yb, "arima", 4, **bt_kw))
        bt_served = counted("13c backtest served", lambda: fc.run_backtest(
            yb, "arima", 4, server=srv, **bt_kw))
        chk.require(json.dumps(bt_served.metrics, sort_keys=True)
                    == json.dumps(bt_local.metrics, sort_keys=True),
                    "13c served backtest metrics == the local campaign's "
                    "(JSON, sorted keys)")
        out["_handoff"]["backtest_metrics"] = bt_served.metrics
        srv.stop(timeout_s=300)
        health = srv.health()
        c = health["counters"]
        chk.require(c["batch_failures"] == 0 and c["solo_retries"] == 0
                    and c["rejected"] == 0 and c["shed"] == 0,
                    f"13b no quarantine, rejection or shed: {c}")
        out["health"] = {k: health[k] for k in ("state", "counters", "queue",
                                                "knobs", "staging_pools")}
        log(f"  health {json.dumps(out['health'])}")
        del tenants, served, direct
        shutil.rmtree(tmp / "srv", ignore_errors=True)

        # -- 13b: SIGKILL and restart, in child processes --------------------
        kroot = tmp / "killed"
        kroot.mkdir()
        me = str(Path(__file__).resolve())
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, me, "--serve-child", "run",
                              str(kroot)], capture_output=True, text=True,
                             timeout=300)
        chk.require(run.returncode == -9, f"13b child server died by SIGKILL "
                    f"(exit {run.returncode}; {run.stderr[-300:]})")
        rec_out = tmp / "recovered.npz"
        rec = subprocess.run([sys.executable, me, "--serve-child", "recover",
                              str(kroot), str(rec_out)], capture_output=True,
                             text=True, timeout=300)
        out["walls_s"]["13b kill + recover children"] = (
            time.perf_counter() - t0)
        chk.require(rec.returncode == 0, f"13b child restart re-answered "
                    f"every request ({rec.stderr[-300:]})")
        if rec.returncode == 0:
            z = np.load(rec_out)
            ref = _kill_server(str(tmp / "uninterrupted"), device)
            tickets = _kill_requests(ref, device)
            ref.start()
            want = [t.result(timeout=600) for t in tickets]
            ref.stop(timeout_s=300)
            same = all(np.array_equal(z[f"{rid}__{f}"],
                                      np.asarray(getattr(w, f)),
                                      equal_nan=z[f"{rid}__{f}"].dtype.kind
                                      == "f")
                       for rid, w in zip(KILL_IDS, want)
                       for f in _FIT_FIELDS)
            chk.require(same and int(z["kill-0__resumed"]) >= 1,
                        "13b the restarted server's answers == an "
                        "uninterrupted server's, bit for bit, with "
                        f"{int(z['kill-0__resumed'])} chunks resumed")
            log(f"  recovered counters {rec.stdout.strip().splitlines()[-1]}")

        # -- 13c: the tick loop ---------------------------------------------
        log(f"phase 13c: TickLoop over {TICK_ROWS} x {TIME} npz shards, "
            f"{TICKS} ticks a cycle, {TICK_CYCLES} cycles, {HORIZON}-step "
            "forecasts published through the sink")
        base = entry.gen_panel(TICK_ROWS, TIME, seed=21,
                               device=device).cpu().numpy()
        gen = np.random.default_rng(22)
        ticks = [gen.normal(scale=0.5, size=(TICK_ROWS, TICKS))
                 .astype(np.float32) for _ in range(TICK_CYCLES)]
        loops = {}
        for name in ("uninterrupted", "crashed"):
            data = tmp / f"ticks_{name}"
            source_mod.write_npz_shards(str(data), base,
                                        rows_per_shard=TICK_CHUNK)
            loops[name] = (tmp / f"loop_{name}", data)

        def loop(name):
            return serving.TickLoop(
                str(loops[name][0]), str(loops[name][1]), model="arima",
                model_kwargs={"order": entry.ORDER}, horizon=HORIZON,
                chunk_rows=TICK_CHUNK, seed=5, device=device)

        lu = loop("uninterrupted")
        for k, tk in enumerate(ticks):
            counted(f"13c cycle {k}", lambda: lu.run_cycle(tk))
            la = out["launches"][f"13c cycle {k}"]
            # cycle 0 fits cold (Hannan-Rissanen init: two moment sweeps a
            # chunk); later cycles refit warm from the journaled params
            chk.require(la["css_fwd"] > 0 and la["css_bwd"] > 0 and (
                k > 0 or la["hr_moments"] == 2 * (TICK_ROWS // TICK_CHUNK)),
                f"13c cycle {k}: the refit and the forecast ran the CSS "
                "kernels")
        lc = loop("crashed")
        lc.run_cycle(ticks[0])
        real = serving.tickloop.walk_mod.forecast_chunked

        def dies(*a, **k):
            raise fi.SimulatedCrash("killed after the cycle's fit commit")

        serving.tickloop.walk_mod.forecast_chunked = dies
        try:
            lc.run_cycle(ticks[1])
            crashed = False
        except fi.SimulatedCrash:
            crashed = True
        finally:
            serving.tickloop.walk_mod.forecast_chunked = real
        lc = loop("crashed")
        counted("13c resume", lambda: lc.resume())
        lc.run_cycle(ticks[2])
        same = all(np.array_equal(lc.published_forecast(k)[0],
                                  lu.published_forecast(k)[0],
                                  equal_nan=True)
                   for k in range(TICK_CYCLES))
        chk.require(crashed and same, "13c a cycle crashed after its fit "
                    "committed, resumed: every cycle published the "
                    "uninterrupted loop's bytes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for p in LANE_DIR.rglob("*.npz"):
            p.unlink()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 13 in {out['phase_s']:.1f} s")
    return out



FLEET_TTL_S = 5.0  # 14b-c: the replicas' lease TTL on the card
WIRE_SECRET = "chip-smoke-wire"  # 14: the wire's shared HMAC secret
WIRE_FAULT_TENANTS = 4  # 14a: tenants resubmitted through the lossy wire
WIRE_FAULT_FRAMES = 12  # 14a: frames each connection's schedule covers
WIRE_FAULT_SEED = 25  # 14a: dup, drop, tear in the first connection's frames
LATE_ID = "late-0"  # 14b: the write sent into the leaderless window
CHAOS_SEED, CHAOS_S = 18, 8.0  # 14c: kill the primary at 2.3 s, pauses
STORM_REQS, STORM_ROWS = 8, 2_048  # 14c: one request a second of the span
CHAOS_MAX_UNAVAILABLE_S = 20.0  # 14c: a TTL, an election and a replay
FLEET_DIR = (Path(__file__).resolve().parent / "chiprun_out"
             / "chip_smoke_fleet")


def _fleet_kwargs(device, cell: int) -> dict:
    """14b-c's replica servers: 13b's SIGKILL child's configuration."""
    return dict(cell_rows=int(cell), max_batch_rows=SERVE_MAX_BATCH,
                max_queue_rows=SERVE_MAX_QUEUE, autotune=False,
                device=str(device))


def fleet_child(root: str, owner: str, device: str, kill: str, cell: str,
                status: str) -> int:
    """14b-c's replica processes: one ``FleetReplica`` on ``root`` whose
    servers fit on ``device`` on a grid of ``cell`` rows, armed with
    ``faultinject.server_kill(kill, mid_commit=True)`` unless ``kill`` is
    ``-``.  It writes its launch counts, counters, role and peak to
    ``status`` every quarter second (a SIGKILLed replica leaves its last
    record) and once more at stop, which ``<root>/stop_<owner>`` asks
    for."""
    import os

    from spark_timeseries_tpu_torch.ops import _build
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import faultinject as fi
    from spark_timeseries_tpu_torch.serving.fleet import FleetReplica

    dev = torch.device(device)
    if dev.type == "cuda":
        # the context and the kernels before the election: a TTL never
        # has to cover CUDA's start-up
        torch.zeros(1, device=dev)
        for name in _build.SOURCES:
            _build.load(name)
    kw = _fleet_kwargs(dev, int(cell))
    if kill != "-":
        kw["_commit_hook"] = fi.server_kill(int(kill), mid_commit=True)
    rep = FleetReplica(root, owner=owner, ttl_s=FLEET_TTL_S,
                       server_kwargs=kw)

    def dump():
        rec = {"owner": owner, "pid": os.getpid(), "role": rep.role(),
               "launches": dict(ck.LAUNCHES), "counters": dict(rep.counters),
               "peak_gib": _peak_gib(dev)}
        tmp = status + ".tmp"
        Path(tmp).write_text(json.dumps(rec))
        os.replace(tmp, status)

    rep.start()
    stop = Path(root) / f"stop_{owner}"
    while not stop.exists():
        dump()
        time.sleep(0.25)
    rep.stop(timeout_s=120)
    dump()
    return 0


def phase_wire_fleet(chk: Checks, device, handoff: dict) -> dict:
    """Phase 14: the wire and the fleet.  (14a) a ``TransportServer``
    armed with a secret in front of 13b's ``FitServer``: 13b's eight
    tenants over the socket, a forecast, a wrong secret, a lossy wire;
    (14b) two ``FleetReplica`` child processes on one root, the primary
    killed by SIGKILL mid-commit, the standby's reads in the leaderless
    window, the takeover's re-answers, a backtest through the fleet;
    (14c) a seeded chaos run on that fleet under a request storm."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from spark_timeseries_tpu_torch import entry
    from spark_timeseries_tpu_torch import forecasting as fc
    from spark_timeseries_tpu_torch import serving
    from spark_timeseries_tpu_torch.ops import cuda_kernels as ck
    from spark_timeseries_tpu_torch.reliability import chaos
    from spark_timeseries_tpu_torch.reliability import faultinject as fi
    from spark_timeseries_tpu_torch.reliability import journal
    from spark_timeseries_tpu_torch.serving import transport
    from spark_timeseries_tpu_torch.serving.fleet import discover_endpoints

    out = {"walls_s": {}, "launches": {}, "peak_gib": {}}
    t_phase = time.perf_counter()
    kernels3 = ("css_fwd", "css_bwd", "hr_moments")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_wire_"))
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    FLEET_DIR.mkdir(parents=True)
    secret = WIRE_SECRET.encode()
    kw = {"order": list(entry.ORDER)}
    children: dict = {}

    def counted(name, fn):
        _sync(device)
        _peak_gib(device, reset=True)
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            _sync(device)
            out["walls_s"][name] = time.perf_counter() - t0
            out["launches"][name] = {k: ck.LAUNCHES[k] for k in kernels3}
            out["peak_gib"][name] = _peak_gib(device)
            log(f"  {name}: {out['walls_s'][name]:.3f} s, launches "
                f"{out['launches'][name]}, peak "
                f"{out['peak_gib'][name]:.2f} GiB")

    def client(endpoints, **kw2):
        kw2.setdefault("deadline_s", 600.0)
        kw2.setdefault("secret", secret)
        return serving.FitClient(endpoints, **kw2)

    def spawn(owner, kill="-"):
        st = FLEET_DIR / f"status_{owner}.json"
        if st.exists():
            st.unlink()
        env = dict(os.environ, STSTPU_WIRE_SECRET=WIRE_SECRET)
        # stderr to a file: a pipe nobody reads could fill and stall a child
        with open(FLEET_DIR / f"{owner}.err", "a") as err:
            proc = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 "--fleet-child", str(root), owner, str(device), str(kill),
                 str(KILL_ROWS), str(st)],
                env=env, stdout=subprocess.DEVNULL, stderr=err)
        children[owner] = (proc, st)
        return proc

    def status(owner) -> dict:
        try:
            return json.loads(children[owner][1].read_text())
        except (OSError, ValueError):
            return {}

    def wait(cond, timeout_s, what):
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.05)
        chk.require(False, f"14 waited {timeout_s:.0f} s for {what}")
        return False

    def holder():
        return journal.read_lease(str(root)) or {}

    try:
        # -- 14a: one server over the wire ------------------------------------
        log(f"phase 14a: TransportServer (HMAC armed) in front of 13b's "
            f"FitServer on {device}: {SERVE_TENANTS} tenants x {SERVE_ROWS} "
            f"x {TIME} ragged rows from {SERVE_TENANTS} client threads")
        tenants = [_tenant_rows(SERVE_ROWS, 100 + i, device)
                   for i in range(SERVE_TENANTS)]
        srv = serving.FitServer(
            str(tmp / "srv"), cell_rows=SERVE_CELL,
            max_batch_rows=SERVE_MAX_BATCH, max_queue_rows=SERVE_MAX_QUEUE,
            autotune=False, device=device)
        ts = transport.TransportServer(srv, secret=secret).start()
        ids = [f"w{i}" for i in range(SERVE_TENANTS)]

        def wired():
            # every tenant is admitted over the wire before the serve loop
            # starts, so the batches are 13b's pairs
            def one(i):
                with client([ts.address]) as c:
                    return c.submit(f"t{i}", tenants[i], "arima",
                                    request_id=ids[i], **kw)

            tickets, errors = fi.request_storm(
                one, [((i,), {}) for i in range(SERVE_TENANTS)],
                threads=SERVE_TENANTS, timeout_s=600)
            chk.require(not any(errors), f"14a every wired submit admitted "
                        f"({[repr(e)[:80] for e in errors if e]})")
            srv.start()
            with client([ts.address]) as c:
                return [c.result_for(rid, timeout=600) for rid in ids]

        got = counted("14a wired fit requests", wired)
        served = handoff["served"]
        chk.require(len(got) == SERVE_TENANTS and all(
            _same_walk(g, s) for g, s in zip(got, served)),
            "14a every wired tenant == 13b's in-process answer, bit for bit")
        chk.require(out["launches"]["14a wired fit requests"]
                    == handoff["launches"],
                    f"14a launches {out['launches']['14a wired fit requests']}"
                    f" == 13b's {handoff['launches']}")
        chk.require(all(g.meta == json.loads(json.dumps(g.meta))
                        and g.meta["batch_members"] == 2 for g in got),
                    "14a wired meta is JSON-native, two-member batches")
        out["wired_vs_inprocess_s"] = {
            "wired": out["walls_s"]["14a wired fit requests"],
            "in-process (13b)": handoff["wall"]}
        wired_s = out["walls_s"]["14a wired fit requests"]
        log(f"  14a walls: wired {wired_s:.3f} s, in-process (13b) "
            f"{handoff['wall']:.3f} s")
        fkw = dict(model="arima", horizon=HORIZON,
                   model_kwargs={"order": entry.ORDER})
        with client([ts.address]) as c:
            fw = counted("14a wired forecast", lambda: c.submit_forecast(
                "t0", tenants[0], served[0], request_id="fw-0",
                **fkw).result(timeout=600))
        fl = srv.submit_forecast("t0", tenants[0], served[0],
                                 request_id="fl-0", **fkw).result(timeout=600)
        chk.require(_same_walk(fw, fl), "14a wired forecast == the "
                    "in-process forecast, bit for bit")
        chk.require(out["launches"]["14a wired forecast"]["css_fwd"] > 0,
                    "14a the wired forecast ran the CSS kernels")
        t0 = time.monotonic()
        try:
            with client([ts.address], secret=b"wrong", retries=8) as c:
                c.ping()
            refused = False
        except transport.WireAuthError:
            refused = True
        chk.require(refused and time.monotonic() - t0 < 10.0,
                    "14a a wrong secret is a terminal WireAuthError, not "
                    f"retried ({time.monotonic() - t0:.2f} s)")
        wires = []

        def lossy(sock):
            w = fi.FaultyWire(sock, fi.frame_fault_schedule(
                WIRE_FAULT_SEED + len(wires), WIRE_FAULT_FRAMES, drop_frac=0.1,
                dup_frac=0.1, tear_frac=0.05))
            wires.append(w)
            return w

        t0 = time.perf_counter()
        with client([ts.address], io_timeout_s=5.0, backoff_base_s=0.02,
                    _wire_wrap=lossy) as c:
            lossy_got = [c.submit(f"t{i}", tenants[i], "arima",
                                  request_id=ids[i], **kw).result(timeout=600)
                         for i in range(WIRE_FAULT_TENANTS)]
        out["walls_s"]["14a lossy wire"] = time.perf_counter() - t0
        faults = [f for w in wires for f in w.log if f != "pass"]
        chk.require(all(_same_walk(g, s) for g, s in zip(lossy_got, served))
                    and faults, f"14a through a FaultyWire ({faults}) the "
                    "same bits")
        out["wire_faults"] = faults
        ts.stop()
        srv.stop(timeout_s=300)
        del tenants, got, lossy_got, srv
        shutil.rmtree(tmp / "srv", ignore_errors=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the children share the card

        # -- 14b: a fleet of two replicas ------------------------------------
        root = FLEET_DIR / "root"
        root.mkdir()
        log(f"phase 14b: two FleetReplica children on one root, TTL "
            f"{FLEET_TTL_S} s, cell {KILL_ROWS}; the primary dies by "
            "SIGKILL mid-commit")
        kill_rows = [_tenant_rows(KILL_ROWS, 300 + i, device)
                     for i in range(len(KILL_IDS))]
        late_rows = _tenant_rows(KILL_ROWS, 310, device)
        ref = serving.FitServer(str(tmp / "uninterrupted"),
                                **_fleet_kwargs(device, KILL_ROWS))
        ref.start()
        want = [ref.submit(f"k{i}", v, "arima", request_id=rid,
                           **kw).result(timeout=600)
                for i, (rid, v) in enumerate(zip(KILL_IDS, kill_rows))]
        want_late = ref.submit("late", late_rows, "arima",
                               request_id=LATE_ID, **kw).result(timeout=600)
        want_fc = ref.submit_forecast("k0", kill_rows[0], want[0],
                                      request_id="fs-0",
                                      **fkw).result(timeout=600)
        ref.stop(timeout_s=300)
        os.sync()  # 14a's gigabyte of records must not stall the leases
        t_fleet = time.perf_counter()
        samples, stop_samp = [], threading.Event()

        def sample():
            # the lease's heartbeat age while the fleet runs: a primary
            # whose fsyncs or GIL starve its heartbeat shows here first
            while not stop_samp.is_set():
                rec = holder()
                if "heartbeat_at" in rec:
                    samples.append((round(time.perf_counter() - t_fleet, 2),
                                    rec.get("owner"), rec.get("token"),
                                    round(time.time() - rec["heartbeat_at"],
                                          2)))
                stop_samp.wait(0.1)

        sampler = threading.Thread(target=sample, daemon=True)
        sampler.start()

        a = spawn("a", kill=2)
        wait(lambda: holder().get("owner") == "a" or a.poll() is not None,
             180, "replica a's lease")
        token_a = holder().get("token")
        spawn("b")
        wait(lambda: len(discover_endpoints(str(root))) == 2, 180,
             "replica b's advert")
        out["walls_s"]["14b two children up"] = time.perf_counter() - t_fleet
        eps = discover_endpoints(str(root))
        ep_b = json.loads((root / "endpoints" / "b.json").read_text())
        ep_b = (ep_b["host"], ep_b["port"])
        cli = client(eps, backoff_base_s=0.02, retries=64)
        first = cli.submit("k0", kill_rows[0], "arima", request_id=KILL_IDS[0],
                           **kw).result(timeout=600)
        # the next commit is the primary's second: it dies inside it.  The
        # submits run on a thread of their own: one that reaches the
        # primary after its death retries until the election, and the
        # window below must be watched while it lasts
        inflight = {}
        ci = client(eps, backoff_base_s=0.02, retries=64)

        def send_inflight():
            for i in (1, 2):
                inflight[i] = ci.submit(f"k{i}", kill_rows[i], "arima",
                                        request_id=KILL_IDS[i], **kw)

        sender = threading.Thread(target=send_inflight, daemon=True)
        sender.start()
        wait(lambda: a.poll() is not None, 300, "replica a's death")
        t_dead = time.perf_counter()
        chk.require(a.returncode == -signal.SIGKILL and holder().get(
            "owner") == "a", f"14b the primary died by SIGKILL mid-commit "
            f"(exit {a.returncode}), the lease still names it")
        # the leaderless window: writes bounce, reads flow from the standby
        probe = socket_call(ep_b, {"op": "submit"},
                            transport.encode_request_blob(
                                late_rows, {"req_id": LATE_ID,
                                            "tenant": "late",
                                            "model": "arima",
                                            "fit_kwargs": kw, "priority": 0,
                                            "deadline_s": None}), secret)
        chk.require(probe.get("error") in ("not_leader", "read_only"),
                    f"14b a write in the leaderless window: "
                    f"{probe.get('error')}")
        with client([ep_b]) as cb:
            read = cb.result_for(KILL_IDS[0], timeout=60)
            fs = cb.submit_forecast("k0", kill_rows[0], first,
                                    request_id="fs-0", **fkw)
        window = time.perf_counter() - t_dead
        late = cli.submit("late", late_rows, "arima", request_id=LATE_ID,
                          **kw)
        chk.require(_same_walk(first, want[0]) and _same_walk(read, want[0]),
                    "14b the standby read a completed result, bit for bit")
        sender.join(600)
        reanswers = [inflight[i].result(timeout=600) for i in (1, 2)
                     if i in inflight]
        ci.close()
        out["walls_s"]["14b death to re-answers"] = (time.perf_counter()
                                                     - t_dead)
        stop_samp.set()
        sampler.join(10)
        ages, dead_s = {}, t_dead - t_fleet
        for t, owner, _, age in samples:
            if owner != "a" or t < dead_s:  # a live holder's record only
                ages[owner] = max(ages.get(owner, 0.0), age)
        out["max_heartbeat_age_s"] = ages
        log(f"  14b the largest heartbeat age of a live holder: {ages} "
            f"(TTL {FLEET_TTL_S} s)")
        rec = holder()
        chk.require(rec.get("owner") == "b" and token_a is not None
                    and rec.get("token", 0) > token_a,
                    f"14b the standby won a higher token ({token_a} -> "
                    f"{rec.get('token')})")
        chk.require(len(reanswers) == 2 and all(
            _same_walk(g, w) for g, w in zip(reanswers, want[1:])),
                    "14b the takeover re-answered every in-flight request == "
                    "an uninterrupted server, bit for bit")
        with client([ep_b]) as cb:
            fs_res = cb.result_for("fs-0", timeout=600)
        chk.require(_same_walk(fs_res, want_fc)
                    and "standby_scratch" in fs_res.meta["journal"]["dir"],
                    "14b the standby's scratch server answered a forecast in "
                    f"the window ({window:.2f} s after the death), bit for "
                    "bit")
        chk.require(_same_walk(late.result(timeout=600), want_late),
                    "14b the bounced write landed on the new primary, bit "
                    "for bit")
        yb = entry.gen_panel(BACKTEST_ROWS, TIME, seed=31, device=device)
        bt = counted("14b backtest through the fleet", lambda:
                     fc.run_backtest(yb, "arima", 4, server=cli,
                                     model_kwargs={"order": entry.ORDER},
                                     device=device))
        chk.require(json.dumps(bt.metrics, sort_keys=True)
                    == json.dumps(handoff["backtest_metrics"],
                                  sort_keys=True),
                    "14b the backtest through the fleet == 13c's served "
                    "backtest (JSON, sorted keys)")
        del yb
        sb = status("b")
        la = sb.get("launches", {})
        chk.require(sb.get("role") == "primary" and all(
            la.get(k, 0) > 0 for k in kernels3),
            f"14b the surviving primary launched the CSS and moment kernels "
            f"on the card: {({k: la.get(k) for k in kernels3})}")
        out["survivor_14b"] = sb

        # -- 14c: a seeded chaos run -----------------------------------------
        log(f"phase 14c: chaos_schedule({CHAOS_SEED}, {CHAOS_S}, n_events=3, "
            "kinds=(kill, pause)) on the fleet, the killed replica restarted, "
            f"under a storm of {STORM_REQS} x {STORM_ROWS} rows")
        spawn("a")  # the killed replica restarted: same owner, new pid
        wait(lambda: status("a").get("role") == "standby"
             and len(discover_endpoints(str(root))) == 2, 180,
             "the restarted replica to join as a standby")
        cli.close()
        eps = discover_endpoints(str(root))
        cli = client(eps, backoff_base_s=0.02, retries=64)
        schedule = chaos.chaos_schedule(CHAOS_SEED, CHAOS_S, n_events=3,
                                        kinds=("kill", "pause"))
        log(f"  schedule {[tuple(e) for e in schedule]}")
        lease_hist, probes, stop_mon = [], [], threading.Event()
        t_chaos = time.monotonic()

        def alive():
            return [o for o, (p, _) in children.items() if p.poll() is None]

        def victim(target):
            owner = holder().get("owner")
            pool = [o for o in alive() if (o == owner) == (target ==
                                                            "primary")]
            return pool[0] if pool else None

        def kill(ev):
            v = victim(ev.target)
            if v is None or len(alive()) < 2:
                log(f"  chaos kill {ev.target}: declined (alive {alive()})")
                return
            children[v][0].send_signal(signal.SIGKILL)
            log(f"  chaos kill {ev.target}: SIGKILL {v}")

        def pause(ev):
            v = victim(ev.target)
            if v is None:
                return
            proc = children[v][0]
            proc.send_signal(signal.SIGSTOP)
            try:
                time.sleep(ev.params["pause_s"])
            finally:
                proc.send_signal(signal.SIGCONT)
            log(f"  chaos pause {ev.target}: {v} for {ev.params['pause_s']} s")

        def monitor():
            with client(eps, deadline_s=5.0, retries=2,
                        backoff_base_s=0.02) as cp:
                while not stop_mon.is_set():
                    rec = holder()
                    if rec.get("token") is not None:
                        lease_hist.append({"token": rec["token"],
                                           "owner": rec["owner"]})
                    try:
                        ok = _same_walk(cp.result_for(KILL_IDS[0],
                                                      timeout=2.0), want[0])
                    except Exception:  # noqa: BLE001 - a failed probe
                        ok = False
                    probes.append((time.monotonic() - t_chaos, ok))
                    stop_mon.wait(0.1)

        storm_rows = [_tenant_rows(STORM_ROWS, 400 + i, device)
                      for i in range(STORM_REQS)]
        storm_ids = [f"storm-{i}" for i in range(STORM_REQS)]
        mon = threading.Thread(target=monitor, daemon=True)
        mon.start()
        runner = chaos.ChaosRunner(schedule, {"kill": kill, "pause": pause})
        runner.start()
        t0 = time.perf_counter()
        def paced(i):
            # one submit a second of the span: the storm outlives the kill
            time.sleep(i * CHAOS_S / STORM_REQS)
            return cli.submit(f"s{i}", storm_rows[i], "arima",
                              request_id=storm_ids[i], **kw)

        tickets, errors = fi.request_storm(
            paced, [((i,), {}) for i in range(STORM_REQS)],
            threads=STORM_REQS, timeout_s=600)
        answers = {rid: (t.result(timeout=600) if t is not None else None)
                   for rid, t in zip(storm_ids, tickets)}
        fired, ch_errors = runner.join(timeout_s=120)
        reanswers = {rid: cli.result_for(rid, timeout=600)
                     for rid in storm_ids}
        stop_mon.set()
        mon.join(30)
        out["walls_s"]["14c storm under chaos"] = time.perf_counter() - t0
        violations = chaos.check_invariants(
            expected_ids=storm_ids, answers=answers, reanswers=reanswers,
            lease_history=lease_hist, probes=probes,
            max_unavailable_s=CHAOS_MAX_UNAVAILABLE_S)
        chk.require(not any(errors) and violations == [] and ch_errors == []
                    and len(fired) == len(schedule),
                    f"14c check_invariants == [] ({violations}), every event "
                    f"fired ({len(fired)} of {len(schedule)}, errors "
                    f"{ch_errors}), no submit refused")
        windows = chaos.unavailability_windows(probes)
        manifest = {"kind": "chip_smoke_chaos", "seed": CHAOS_SEED,
                    "schedule": [e._asdict() for e in schedule],
                    "fired": fired, "windows": windows,
                    "lease_history": lease_hist[-50:],
                    "violations": [v._asdict() for v in violations]}
        chaos.write_chaos_manifest(str(root), manifest)
        chk.require(chaos.load_chaos_manifest(str(root)) == json.loads(
            json.dumps(manifest)), "14c the chaos manifest was written and "
            "loads back")
        out["chaos"] = {"fired": fired, "windows": windows,
                        "tokens": sorted({h["token"] for h in lease_hist}),
                        "probes": len(probes)}
        cli.close()
    finally:
        for owner in list(children):
            (FLEET_DIR / "root" / f"stop_{owner}").touch()
        for owner, (proc, _) in children.items():
            try:
                proc.wait(timeout=180)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
            err = (FLEET_DIR / f"{owner}.err").read_text()
            if proc.returncode not in (0, -signal.SIGKILL):
                chk.require(False, f"14 replica {owner} exited "
                            f"{proc.returncode}: {err[-400:]}")
            out.setdefault("children", {})[owner] = {
                "exit": proc.returncode, **status(owner)}
        shutil.rmtree(tmp, ignore_errors=True)
        for p in FLEET_DIR.rglob("*.npz"):
            p.unlink()
    for owner, rec in out.get("children", {}).items():
        log(f"  replica {owner}: exit {rec['exit']}, role {rec.get('role')}, "
            f"peak {rec.get('peak_gib', 0.0):.2f} GiB, counters "
            f"{rec.get('counters')}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 14 in {out['phase_s']:.1f} s")
    return out


def socket_call(ep, header: dict, blob: bytes, secret: bytes) -> dict:
    """One raw request/reply on a fresh connection to ``ep``."""
    import socket

    from spark_timeseries_tpu_torch.serving import transport

    with socket.create_connection(ep, timeout=60) as s:
        transport.send_msg(s, {**header, "msg_id": "probe"}, blob, secret)
        reply = transport.recv_msg(s, transport.FrameDecoder(),
                                   secret=secret)
    return reply[0] if reply else {}


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


def failed(chk: Checks) -> int:
    """Report the failed checks on both streams; the exit code."""
    msg = "FAILED: " + "; ".join(chk.failures)
    log(msg)
    print(msg, file=sys.stderr, flush=True)
    return 1


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
    lbfgs = phase_lbfgs(chk, device)
    if chk.failures:  # a kernel that disagrees makes the rest meaningless
        return failed(chk)

    def lap(what):
        """One line of the run's own clock after each phase."""
        log(f"  [{what} done at {time.perf_counter() - t_start:.1f} s]")

    lap("phases 1-3")
    main_run = phase_main(chk, ROWS, TIME, device)
    lap("phase 4")
    pipe = phase_pipeline(chk, VOL_ROWS, VOL_TIME, device)
    lap("phase 5")
    hourly = phase_hourly(chk, HOURLY_ROWS, HOURLY_TIME, device)
    lap("phase 6")
    times = phase_timing(chk, main_run, device)
    times.update(phase_timing_volatility(chk, pipe, device))
    times.update(phase_timing_hourly(chk, hourly, device))
    lag = phase_timing_seasonal(chk, device)
    lap("phase 7")
    search = phase_order_search(chk, device)
    phase_leftovers(chk, main_run.pop("params"), device)
    lap("phase 8")
    resilient = phase_resilient(chk, device, n_built)
    lap("phase 9")
    chunked = phase_chunked(chk, device)
    lap("phase 10")
    search_fc = phase_search_forecast(chk, device)
    lap("phase 11")
    panel_mesh = phase_panel_mesh(chk, device)
    lap("phase 12")
    lanes_serving = phase_lanes_serving(chk, device)
    lap("phase 13")
    wire_fleet = phase_wire_fleet(chk, device,
                                  lanes_serving.pop("_handoff"))
    lap("phase 14")
    log(json.dumps({"css_lag_route": {
        "shape": [HOURLY_TIME - 1 - SEASON, HOURLY_ROWS], "times": lag,
        "launches": {"airline fit (8b)": search["airline_launches"],
                     "seasonal grid (8c)": search["grid_seasonal_launches"]},
        "walls_s": {k: v for k, v in search.items() if k.endswith("_s")}}}))
    log(json.dumps({"lbfgs_kernels": lbfgs}))
    log(json.dumps({"resilient_fit": resilient}))
    log(json.dumps({"chunked_walk": chunked}))
    log(json.dumps({"search_forecast": search_fc}))
    log(json.dumps({"panel_mesh": panel_mesh}))
    log(json.dumps({"lanes_serving": lanes_serving}, default=str))
    log(json.dumps({"wire_fleet": wire_fleet}, default=str))
    if chk.failures:
        return failed(chk)
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
    if sys.argv[1:2] == ["--serve-child"]:
        sys.exit(serve_child(*sys.argv[2:]))
    if sys.argv[1:2] == ["--fleet-child"]:
        sys.exit(fleet_child(*sys.argv[2:]))
    sys.exit(main())

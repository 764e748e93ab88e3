"""Hand-written CUDA kernels of the port, with their wrappers.

Port of ``spark_timeseries_tpu/ops/pallas_kernels.py``.  Eleven kernels,
one for each of the reference's, sources in ``csrc/``:

==============  ===============  ==============================================
wrapper         source           replaces (pallas_kernels.py)
==============  ===============  ==============================================
``css_fwd``     ``css.cu``       ``_css_fwd_kernel`` via ``_css_fwd_call_f``
``css_bwd``     ``css.cu``       ``_css_bwd_kernel`` via ``_css_errors_bwd_f``
``hr_moments``  ``hr.cu``        ``_hr_kernel`` via ``_hr_moments``
``fill_chain``  ``fill.cu``      ``_fillchain_fused_kernel`` via
                                 ``_fill_linear_call_folded``
``autocorr``    ``autocorr.cu``  ``_autocorr_kernel`` via
                                 ``_batch_autocorr_call``
``garch_fwd``   ``garch.cu``     ``_garch_fwd_kernel`` via ``_garch_fwd_call``
``garch_bwd``   ``garch.cu``     ``_garch_bwd_kernel`` via ``_garch_h_bwd``
``ewma_fwd``    ``ewma.cu``      ``_ewma_fwd_kernel`` via ``_ewma_fwd_call``
``ewma_bwd``    ``ewma.cu``      ``_ewma_bwd_kernel`` via ``_ewma_bwd_call``
``hw_fwd``      ``hw.cu``        ``_hw_fwd_kernel`` via ``_hw_fwd_call``
``hw_bwd``      ``hw.cu``        ``_hw_bwd_kernel`` via ``_hw_e_bwd``
==============  ===============  ==============================================

The optimizer's own kernels (``csrc/lbfgs.cu``, which replace no Pallas
kernel) have their wrappers in ``ops.lbfgs_kernels`` and count their
launches in :data:`OPTIM_LAUNCHES`, apart from the objectives'.

Each wrapper checks device, dtype (float32), shape and contiguity and raises
on anything else; it launches its kernel for CUDA tensors (counting the
launch in :data:`LAUNCHES`) and runs the kernel's plain PyTorch version
(``*_plain``: a Python loop over time on ``[B]`` slices, in the kernel's
summation order) only for CPU tensors.  No path catches a failed build or
launch.  Panels are time-major ``[T, B]`` (``ops.layout``).  With the
``obs`` plane on, each CSS launch also feeds the registry's ``work.css_*``
counters (:func:`_count_css_work`): every launch, and what a lag-route
launch must move.

Above the wrappers sit the reference's entry points with its signatures,
minus ``interpret``: ``css_neg_loglik``, ``css_neg_loglik_folded``,
``css_errors``, ``css_last_errors``, ``hr_init``; ``fill_linear_chain``,
``fill_linear``, ``fill_linear_chain_folded``; ``batch_autocorr``,
``batch_autocorr_folded``; ``garch_variances``, ``garch_neg_loglik``;
``ewma_smooth``, ``ewma_sse``; ``hw_seeds``, ``hw_sse_seeded``, ``hw_sse``.
The CSS, GARCH, EWMA and Holt-Winters objectives are
``torch.autograd.Function``s whose backward is the adjoint kernel.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from .. import obs
from . import _build
from .layout import FoldedPanel, css_prefold, time_major

__all__ = [
    "LAUNCHES", "OPTIM_LAUNCHES", "ROUTE_LAUNCHES", "reset_launch_counts",
    "supported",
    "css_structural_ok", "css_route",
    "hr_structural_ok", "css_fwd", "css_fwd_plain", "css_bwd",
    "css_bwd_plain", "hr_moments", "hr_moments_plain", "css_errors",
    "css_last_errors", "css_neg_loglik", "css_neg_loglik_folded",
    "css_sse_folded", "hr_init",
    "css_prefold", "autocorr_structural_ok", "fill_chain",
    "fill_chain_plain", "autocorr", "autocorr_plain", "garch_fwd",
    "garch_fwd_plain", "garch_bwd", "garch_bwd_plain", "fill_linear_chain",
    "fill_linear", "fill_linear_chain_folded", "batch_autocorr",
    "batch_autocorr_folded", "garch_variances", "garch_neg_loglik",
    "garch_h0_folded", "garch_neg_loglik_folded", "garch_prefold",
    "CHAIN_OUTPUTS", "ewma_fwd", "ewma_fwd_plain", "ewma_bwd",
    "ewma_bwd_plain", "ewma_smooth", "ewma_prefold", "ewma_sse",
    "ewma_sse_folded", "hw_ring_in_registers", "hw_structural_ok", "hw_fwd",
    "hw_fwd_plain", "hw_bwd", "hw_bwd_plain", "hw_seeds", "hw_sse_folded",
    "hw_sse_seeded", "hw_sse", "hw_additive_sse",
]

# kernel launches by wrapper name (plain-version calls are not counted)
LAUNCHES = {"css_fwd": 0, "css_bwd": 0, "hr_moments": 0, "fill_chain": 0,
            "autocorr": 0, "garch_fwd": 0, "garch_bwd": 0, "ewma_fwd": 0,
            "ewma_bwd": 0, "hw_fwd": 0, "hw_bwd": 0}

# the optimizer's launches by wrapper name (``ops.lbfgs_kernels``), apart
# from the objective's, so that ``LAUNCHES`` keeps counting the same work
OPTIM_LAUNCHES = {"lbfgs_direction": 0, "lbfgs_trial": 0, "lbfgs_update": 0}

# the CSS launches by css.cu's route (:func:`css_route`)
CSS_ROUTES = ("register", "lag", "local")
ROUTE_LAUNCHES = {name: dict.fromkeys(CSS_ROUTES, 0)
                  for name in ("css_fwd", "css_bwd")}
# the counts are read-modify-writes on shared dicts: the chunk walk's lanes
# launch from several threads at once, so every increment and the reset
# hold this lock (a bare ``+= 1`` can lose a count between threads)
_COUNT_LOCK = threading.Lock()

_MODES = {"e": 0, "sum": 1, "both": 2, "tail": 3}
_CSS_REG_LAG = 8
_MAX_CSS_LAG = 512
_MAX_ACF_LAG = 1024
_MAX_HW_PERIOD = 1024
# css.cu's lag route: listed lags a side, a ring row (one float a thread of
# a 128-thread block), the panel stream's depth in steps, and the dynamic
# shared memory a block may have
_CSS_LAG_CAP = 32
_CSS_ROW_BYTES = 4 * 128
_CSS_STREAM_DEPTH = 32
_SMEM_LIMIT = 227 * 1024


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, OPTIM_LAUNCHES):
            for name in counts:
                counts[name] = 0
        for counts in ROUTE_LAUNCHES.values():
            for route in counts:
                counts[route] = 0


def _count_launch(counter: str) -> None:
    with _COUNT_LOCK:
        counts = OPTIM_LAUNCHES if counter in OPTIM_LAUNCHES else LAUNCHES
        counts[counter] += 1


def _count_route(counter: str, route: str) -> None:
    with _COUNT_LOCK:
        ROUTE_LAUNCHES[counter][route] += 1


def _count_css_work(route: str, B: int, row_steps: dict, row_floats: int,
                    coef_rows: int) -> None:
    """One CSS launch in the ``obs`` registry (no-ops with the plane off),
    from host integers only: every launch in ``work.css_launches``; one on
    the lag route also in ``work.css_lag_launches``, with what it must
    move: ``row_steps`` (``{kind: rows x steps}`` into
    ``work.css_lag_row_steps.<kind>``), ``row_floats`` floats a row read
    or written once (``work.css_lag_row_floats``) and ``coef_rows``
    coefficient and gradient rows (``work.css_lag_coef_floats``)."""
    if not obs.enabled():
        return
    obs.counter("work.css_launches").inc()
    if route != "lag":
        return
    obs.counter("work.css_lag_launches").inc()
    for kind, n in row_steps.items():
        if n:
            obs.counter(f"work.css_lag_row_steps.{kind}").inc(n)
    obs.counter("work.css_lag_row_floats").inc(B * row_floats)
    obs.counter("work.css_lag_coef_floats").inc(B * coef_rows)


def _listed(p: int, q: int, lags) -> tuple:
    """``(KA, KM)``: the lags a side the kernels read."""
    return (p, q) if lags is None else (len(lags[0]), len(lags[1]))


def supported(x: torch.Tensor) -> bool:
    """True when the kernels can run on ``x``: float32 on a CUDA device."""
    return x.is_cuda and x.dtype == torch.float32


def css_structural_ok(p: int, q: int) -> bool:
    """Orders the CSS kernels take: rings of up to 512 lags (the
    reference's bound, ``pallas_kernels.css_structural_ok``)."""
    return 0 <= p <= _MAX_CSS_LAG and 0 <= q <= _MAX_CSS_LAG


def _css_lags(p: int, q: int, lags):
    """``lags`` as ``(ar, ma)``: sorted tuples of distinct lags in ``1..p``
    and ``1..q``; None for None or for every lag of both sides."""
    if lags is None:
        return None
    ar, ma = (tuple(sorted({int(v) for v in side})) for side in lags)
    if (ar and not 1 <= ar[0] <= ar[-1] <= p) or \
            (ma and not 1 <= ma[0] <= ma[-1] <= q):
        raise ValueError(f"lags {lags} outside 1..p={p}, 1..q={q}")
    if ar == tuple(range(1, p + 1)) and ma == tuple(range(1, q + 1)):
        return None
    return ar, ma


def _ring_len(n: int) -> int:
    """Least power of two above ``n``."""
    return 1 << int(n).bit_length()


def css_route(p: int, q: int, lags=None) -> str:
    """The route of ``csrc/css.cu`` for order ``(p, q)`` with structural
    lags ``lags`` (``(ar, ma)``; None: every lag), as its ``route_of``
    takes it: ``"register"`` (p, q <= 8, every lag), ``"lag"`` (up to 32
    listed lags a side whose shared-memory rings fit a block: the panel
    stream, the forward's y and e rings with the tail's e ring, the
    adjoint's three streamed panels and a ring) or ``"local"``."""
    lags = _css_lags(p, q, lags)
    if lags is None and p <= _CSS_REG_LAG and q <= _CSS_REG_LAG:
        return "register"
    ar, ma = lags or (range(1, p + 1), range(1, q + 1))
    if len(ar) > _CSS_LAG_CAP or len(ma) > _CSS_LAG_CAP:
        return "local"
    da, dm = max(ar, default=0), max(ma, default=0)
    fwd = (_CSS_STREAM_DEPTH + (_ring_len(da) if ar else 0)
           + (_ring_len(max(q, dm)) if ma or q else 0))
    bwd = 3 * _CSS_STREAM_DEPTH + (_ring_len(max(da, dm)) if ar or ma else 0)
    return ("lag" if max(fwd, bwd) * _CSS_ROW_BYTES <= _SMEM_LIMIT
            else "local")


def hr_structural_ok(p: int, q: int) -> bool:
    """Orders the moment kernel takes: p, q <= 8 (at most 32 columns)."""
    return 0 <= p <= 8 and 0 <= q <= 8


def autocorr_structural_ok(num_lags: int, n_time: int) -> bool:
    """Lag counts the autocorrelation kernel takes: ``0 < num_lags <
    min(T, 1024)`` (the reference's bound)."""
    return 0 < num_lags < min(n_time, _MAX_ACF_LAG)


def hw_structural_ok(period: int) -> bool:
    """Seasonal periods the Holt-Winters kernels take: ``0 < period <=
    1024`` (the reference's bound, ``pallas_kernels.hw_structural_ok``)."""
    return 0 < period <= _MAX_HW_PERIOD


def hw_ring_in_registers(period: int) -> bool:
    """True when ``csrc/hw.cu`` instantiates ``period`` with its seasonal
    rings in registers; any other period keeps them in a global ``[period,
    B]`` scratch.  Asks the built library, which holds the one list."""
    return bool(_build.load("hw").sts_hw_ring_in_registers(int(period)))


def _hw_check_period(period: int) -> None:
    if not hw_structural_ok(period):
        raise ValueError(f"Holt-Winters kernel supports 0 < period <= "
                         f"{_MAX_HW_PERIOD} (got {period}); use "
                         "backend='eager'")


# ---------------------------------------------------------------------------
# argument checks and launch plumbing
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, shape, device,
           dtype=torch.float32) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be "
                        f"{str(dtype).removeprefix('torch.')}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_cuda(device: torch.device) -> bool:
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(lib_name: str, fn: str, counter: str, device, *args,
            route=None) -> None:
    """Launch ``fn`` of ``csrc/<lib_name>.cu``; a CSS launch also counts
    one for its ``route``."""
    _launch_call(lib_name, counter, device,
                 lambda lib, stream: getattr(lib, fn)(*args, stream))
    if route is not None:
        _count_route(counter, route)


def _launch_call(lib_name: str, counter: str, device, call) -> None:
    """Run ``call(library, stream) -> CUDA error`` with the build of
    ``csrc/<lib_name>.cu`` on ``device``'s current stream; raise on an
    error, else count one launch of ``counter``."""
    lib = _build.load(lib_name)
    with torch.cuda.device(device):
        rc = call(lib, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed with CUDA error {rc}")
    _count_launch(counter)


def _t_limit(t_limit, T: int) -> int:
    t_limit = T if t_limit is None else int(t_limit)
    if not 0 <= t_limit <= T:
        raise ValueError(f"t_limit {t_limit} outside [0, {T}]")
    return t_limit


# ---------------------------------------------------------------------------
# CSS forward: e_t = m_t (y_t - c - sum phi_i y_{t-i} - sum theta_j e_{t-j})
# ---------------------------------------------------------------------------


def css_fwd(yt, params, zb, p: int, q: int, mode: str, t_limit=None,
            lags=None):
    """CSS errors of ``[T, B]`` panel ``yt`` under ``params [B, 1+p+q]``
    (``[c, phi, theta]``) with the live mask ``zb <= t < t_limit``.

    ``mode``: ``"e"`` -> errors ``[T, B]``; ``"sum"`` -> per-series SSE
    ``[B]``; ``"both"`` -> ``(e, sse)`` with the SSE bitwise equal to
    ``"sum"``; ``"tail"`` -> the last ``q`` errors before ``t_limit``,
    ``[B, q]`` oldest first.  ``lags``: ``(ar, ma)``, the structural lags
    the recursion reads (the other coefficients are taken as 0); None:
    every lag.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown css_fwd mode {mode!r}")
    if not css_structural_ok(p, q):
        raise ValueError(f"CSS kernel supports p, q <= {_MAX_CSS_LAG} "
                         f"(got p={p}, q={q})")
    T, B = yt.shape
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("params", params, (B, 1 + p + q), dev)
    _check("zb", zb, (B,), dev)
    t_limit = _t_limit(t_limit, T)
    if mode == "tail" and t_limit < q:
        raise ValueError(f"t_limit {t_limit} < q={q}")
    lags = _css_lags(p, q, lags)
    if not _on_cuda(dev):
        return css_fwd_plain(yt, params, zb, p, q, mode, t_limit, lags)
    e = torch.empty_like(yt) if mode in ("e", "both") else None
    sse = yt.new_empty(B) if mode in ("sum", "both") else None
    tail = yt.new_empty(q, B) if mode == "tail" else None
    if B:
        route = css_route(p, q, lags)
        par_t = _css_rows(params, p, q, lags, route)
        _launch("css", "sts_css_fwd", "css_fwd", dev, _ptr(yt), _ptr(par_t),
                _ptr(zb), _ptr(e), _ptr(sse), _ptr(tail), B, T, p, q,
                *_c_lags(lags), t_limit, _MODES[mode], route=route)
        # y read over the sweep (and e written in "e" / "both"); zb, the
        # SSE or the tail, and the listed coefficient rows once a row
        steps = t_limit if mode == "tail" else T
        _count_css_work(route, B, {mode: B * steps},
                        1 + (sse is not None) + (q if tail is not None else 0),
                        1 + sum(_listed(p, q, lags)))
    return _fwd_out(mode, e, sse, None if tail is None else tail.t())


def _c_lags(lags) -> tuple:
    """``(lags, ka, km)`` as ``sts_css_fwd`` / ``sts_css_bwd`` take them: a
    host int array of the AR then the MA lags, or null for every lag."""
    if lags is None:
        return None, 0, 0
    ar, ma = lags
    return (ctypes.c_int * max(len(ar) + len(ma), 1))(*ar, *ma), len(ar), \
        len(ma)


_INDEX = {}  # (device, rows) -> index tensor, made once


def _index(device, rows: tuple) -> torch.Tensor:
    key = (device, rows)
    idx = _INDEX.get(key)
    if idx is None:
        idx = _INDEX[key] = torch.tensor(rows, dtype=torch.long,
                                         device=device)
    return idx


def _unlisted(p: int, q: int, lags) -> tuple:
    """Rows of ``[c, phi, theta]`` outside the lags (none for None)."""
    if lags is None:
        return ()
    ar, ma = lags
    listed = {0, *ar, *(p + j for j in ma)}
    return tuple(r for r in range(1 + p + q) if r not in listed)


def _css_rows(params, p: int, q: int, lags, route: str):
    """The coefficient rows a route's kernel reads: ``[1 + KA + KM, B]``
    of the listed lags on the lag route, else ``[1+p+q, B]`` with the
    unlisted rows zeroed."""
    if lags is None:
        return params.t().contiguous()
    if route == "lag":
        ar, ma = lags
        rows = (0, *ar, *(p + j for j in ma))
        return params.t().index_select(0, _index(params.device, rows))
    par_t = params.t().contiguous()
    return par_t.index_fill_(0, _index(params.device,
                                       _unlisted(p, q, lags)), 0.0)


def _fwd_out(mode, e, sse, tail):
    return {"e": e, "sum": sse, "both": (e, sse), "tail": tail}[mode]


def _lag_slots(p: int, q: int, lags):
    """The listed lags as 0-based window slots ``(ar, ma)``, ascending."""
    lags = _css_lags(p, q, lags)
    if lags is None:
        return range(p), range(q)
    return [i - 1 for i in lags[0]], [j - 1 for j in lags[1]]


def css_fwd_plain(yt, params, zb, p: int, q: int, mode: str, t_limit=None,
                  lags=None):
    """Plain PyTorch version of :func:`css_fwd` (same arguments, same
    per-step arithmetic and summation order)."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    ar, ma = _lag_slots(p, q, lags)
    c = params[:, 0]
    phi = params[:, 1:1 + p]
    th = params[:, 1 + p:1 + p + q]
    zero = yt.new_zeros(B)
    yl = [zero] * p  # yl[i] = y_{t-1-i}
    el = [zero] * q  # el[j] = e_{t-1-j}
    acc = zero
    es = []
    for t in range(t_limit if mode == "tail" else T):
        yv = yt[t]
        pred = c
        for i in ar:
            pred = pred + phi[:, i] * yl[i]
        for j in ma:
            pred = pred + th[:, j] * el[j]
        live = (zb <= t) & (t < t_limit)
        et = torch.where(live, yv - pred, 0.0)
        if mode in ("e", "both"):
            es.append(et)
        acc = acc + et * et
        if p:
            yl = [yv] + yl[:p - 1]
        if q:
            el = [et] + el[:q - 1]
    e = torch.stack(es) if mode in ("e", "both") else None
    tail = (torch.stack(el[::-1], dim=1) if q else yt.new_zeros(B, 0)) \
        if mode == "tail" else None
    return _fwd_out(mode, e, acc, tail)


# ---------------------------------------------------------------------------
# CSS adjoint: a_t = m_t (g_t - sum theta_j a_{t+j})
# ---------------------------------------------------------------------------


def css_bwd(yt, et, params, zb, g, p: int, q: int, want_gy: bool = False,
            t_limit=None, lags=None):
    """Gradients of the CSS errors' cotangent ``g`` -> ``(gparams [B, k],
    gy [T, B] or None)``.

    ``g`` is either the errors' cotangent ``[T, B]`` or, for the objective
    ``sum_t e_t^2``, its per-series cotangent ``[B]`` (``g_t = 2 e_t g`` is
    formed in the kernel).  ``gy`` (the data cotangent) is computed only
    with ``want_gy``.  ``lags`` as :func:`css_fwd`'s; the gradient of an
    unlisted coefficient is exactly 0.
    """
    if not css_structural_ok(p, q):
        raise ValueError(f"CSS kernel supports p, q <= {_MAX_CSS_LAG} "
                         f"(got p={p}, q={q})")
    T, B = yt.shape
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("et", et, (T, B), dev)
    _check("params", params, (B, 1 + p + q), dev)
    _check("zb", zb, (B,), dev)
    g_is_sse = g.dim() == 1
    _check("g", g, (B,) if g_is_sse else (T, B), dev)
    t_limit = _t_limit(t_limit, T)
    lags = _css_lags(p, q, lags)
    if not _on_cuda(dev):
        return css_bwd_plain(yt, et, params, zb, g, p, q, want_gy, t_limit,
                             lags)
    route = css_route(p, q, lags)
    # the lag route writes the listed rows only
    gpar = (yt.new_zeros if route == "lag" else yt.new_empty)(1 + p + q, B)
    gy = torch.empty_like(yt) if want_gy else None
    if B:
        par_t = _css_rows(params, p, q, lags, route)
        _launch("css", "sts_css_bwd", "css_bwd", dev, _ptr(yt), _ptr(et),
                _ptr(par_t), _ptr(zb), _ptr(g), _ptr(gpar), _ptr(gy), B, T,
                p, q, *_c_lags(lags), t_limit, int(g_is_sse), route=route)
        # the panels css.cu's lag adjoint streams: y with AR lags, e with
        # MA lags or for the per-series cotangent, g when it is a panel,
        # and gy written; zb (and g a row) once; coefficient rows read and
        # gradient rows written
        ka, km = _listed(p, q, lags)
        n = B * T
        _count_css_work(route, B, {
            "bwd": n, "bwd_y": n * (ka > 0), "bwd_e": n * (km > 0 or g_is_sse),
            "bwd_g": n * (not g_is_sse), "bwd_gy": n * want_gy},
            1 + g_is_sse, 2 * (1 + ka + km))
        if route == "local" and lags is not None:
            gpar.index_fill_(0, _index(dev, _unlisted(p, q, lags)), 0.0)
    return gpar.t(), gy


def css_bwd_plain(yt, et, params, zb, g, p: int, q: int,
                  want_gy: bool = False, t_limit=None, lags=None):
    """Plain PyTorch version of :func:`css_bwd` (the kernel's order: t
    descending, lags nearest first)."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    ar, ma = _lag_slots(p, q, lags)
    g_is_sse = g.dim() == 1
    phi = params[:, 1:1 + p]
    th = params[:, 1 + p:1 + p + q]
    zero = yt.new_zeros(B)
    ac = max(p, q)
    al = [zero] * ac  # al[i] = a_{t+1+i}
    gc, gphi, gth = zero, [zero] * p, [zero] * q
    gys = [None] * T
    for t in reversed(range(T)):
        gt = 2.0 * et[t] * g if g_is_sse else g[t]
        av = gt
        for j in ma:
            av = av - th[:, j] * al[j]
        live = (zb <= t) & (t < t_limit)
        a = torch.where(live, av, 0.0)
        if want_gy:
            d = a
            for i in ar:
                d = d - phi[:, i] * al[i]
            gys[t] = d
        gc = gc - a
        for i in ar:
            if t - 1 - i >= 0:
                gphi[i] = gphi[i] - yt[t - 1 - i] * a
        for j in ma:
            if t - 1 - j >= 0:
                gth[j] = gth[j] - et[t - 1 - j] * a
        if ac:
            al = [a] + al[:ac - 1]
    gparams = torch.stack([gc, *gphi, *gth], dim=1)
    return gparams, (torch.stack(gys) if want_gy else None)


# ---------------------------------------------------------------------------
# Hannan-Rissanen moment sweep
# ---------------------------------------------------------------------------


def _tri(n: int, a: int, c: int) -> int:
    return a * n - a * (a - 1) // 2 + (c - a)


def _hr_ncols(lag_y, lag_e, intercept):
    ncols = int(intercept) + lag_y + lag_e
    return ncols, ncols * (ncols + 1) // 2 + ncols


def hr_moments(yt, zb, lag_y: int, lag_e: int, intercept: bool, woff: int,
               beta_m: int = 0, beta=None, t_limit=None):
    """Weighted lagged moment sums ``[B, nacc]`` of the ``[T, B]`` panel.

    Columns at step t: ``[1 (intercept), y_{t-1}..y_{t-lag_y},
    eh_{t-1}..eh_{t-lag_e}]`` with weight ``[zb + woff <= t < t_limit]``;
    the output holds ``sum w c_a c_b`` (a <= b, upper triangle row by row)
    then ``sum w c_a y_t``.  With ``lag_e > 0`` the residual ``eh`` of the
    AR(``beta_m``) fit ``beta [B, beta_m + 1]`` is rebuilt on the fly.
    """
    T, B = yt.shape
    dev = yt.device
    ncols, nacc = _hr_ncols(lag_y, lag_e, intercept)
    if not 1 <= ncols <= 32:
        raise ValueError(f"moment kernel takes 1..32 columns, got {ncols}")
    if lag_e and not 0 <= beta_m <= ncols + 1:
        raise ValueError(f"beta_m {beta_m} outside [0, {ncols + 1}]")
    _check("yt", yt, (T, B), dev)
    _check("zb", zb, (B,), dev)
    if lag_e:
        _check("beta", beta, (B, beta_m + 1), dev)
    t_limit = _t_limit(t_limit, T)
    if not _on_cuda(dev):
        return hr_moments_plain(yt, zb, lag_y, lag_e, intercept, woff,
                                beta_m, beta, t_limit)
    acc = yt.new_empty(nacc, B)
    if B:
        _launch_call("hr", "hr_moments", dev, lambda lib, st: _hr_moments_call(
            lib, st, yt, zb, acc, lag_y, lag_e, intercept, woff, beta_m,
            beta, t_limit))
    return acc.t()


def _hr_moments_call(lib, stream, yt, zb, acc, lag_y: int, lag_e: int,
                     intercept: bool, woff: int, beta_m: int = 0, beta=None,
                     t_limit=None) -> int:
    """Launch the moment sweep of ``lib`` (a build of ``hr.cu``) on
    ``stream`` into ``acc [nacc, B]``, arguments as :func:`hr_moments`
    takes them -> the CUDA error.  The one place that packs
    ``sts_hr_moments``' arguments, for every build that is called."""
    T, B = yt.shape
    beta_t = beta.t().contiguous() if lag_e else None
    return lib.sts_hr_moments(
        _ptr(yt), _ptr(zb), _ptr(beta_t), _ptr(acc), B, T, lag_y, lag_e,
        int(intercept), woff, beta_m if lag_e else 0,
        T if t_limit is None else t_limit, stream)


def hr_moments_plain(yt, zb, lag_y: int, lag_e: int, intercept: bool,
                     woff: int, beta_m: int = 0, beta=None, t_limit=None):
    """Plain PyTorch version of :func:`hr_moments`."""
    T, B = yt.shape
    t_limit = T if t_limit is None else int(t_limit)
    ncols, nacc = _hr_ncols(lag_y, lag_e, intercept)
    npair = nacc - ncols
    ic = int(intercept)
    zero = yt.new_zeros(B)
    col = [yt.new_ones(B)] * ic + [zero] * (lag_y + lag_e)
    yr = [zero] * beta_m  # yr[i] = y_{t-1-i}
    s = [zero] * nacc
    zw = zb + woff
    z1 = zb + beta_m
    for t in range(min(t_limit, T)):
        yv = yt[t]
        w = (zw <= t).to(yt.dtype)
        for a in range(ncols):
            wa = w * col[a]
            for c in range(a, ncols):
                s[_tri(ncols, a, c)] = s[_tri(ncols, a, c)] + wa * col[c]
            s[npair + a] = s[npair + a] + wa * yv
        if lag_e:
            pred = beta[:, 0]
            for i in range(beta_m):
                pred = pred + beta[:, i + 1] * yr[i]
            eh = (z1 <= t).to(yt.dtype) * (yv - pred)
            ecols = [eh] + col[ic + lag_y:ic + lag_y + lag_e - 1]
        else:
            ecols = []
        ycols = [yv] + col[ic:ic + lag_y - 1] if lag_y else []
        col = col[:ic] + ycols + ecols
        if beta_m:
            yr = [yv] + yr[:beta_m - 1]
    return torch.stack(s, dim=1)


# ---------------------------------------------------------------------------
# fill-linear chain: (filled, lag-1 difference, lag-1 shift)
# ---------------------------------------------------------------------------

CHAIN_OUTPUTS = ("filled", "diff", "lag")


def _panel_shape(name: str, x) -> tuple:
    if not isinstance(x, torch.Tensor) or x.dim() != 2:
        raise ValueError(f"{name} must be a [T, B] tensor")
    return tuple(x.shape)


def fill_chain(yt, which=(True, True, True)):
    """Linear fill of the interior NaN gaps of the ``[T, B]`` panel ``yt``,
    with its lag-1 difference and lag-1 shift -> the ``[T, B]`` outputs that
    ``which`` (flags for ``(filled, diff, lag)``) asks for, in that order.

    Leading and trailing NaN runs stay NaN; the difference and the shift
    are NaN at t = 0, and a NaN fill at t-1 makes the difference NaN.
    """
    which = tuple(bool(w) for w in which)
    if len(which) != 3 or not any(which):
        raise ValueError(f"which must flag 1-3 of {CHAIN_OUTPUTS}, got "
                         f"{which!r}")
    T, B = _panel_shape("yt", yt)
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    if not _on_cuda(dev):
        return fill_chain_plain(yt, which)
    outs = [torch.empty_like(yt) if w else None for w in which]
    if B and T:
        _launch("fill", "sts_fill_chain", "fill_chain", dev, _ptr(yt),
                *(_ptr(o) for o in outs), B, T)
    return tuple(o for o in outs if o is not None)


def fill_chain_plain(yt, which=(True, True, True)):
    """Plain PyTorch version of :func:`fill_chain`: a backward sweep for the
    next valid (value, index), then the forward fill with the kernel's
    arithmetic (the kernel finds the next valid value when it closes a
    gap; the values are the same)."""
    T, B = yt.shape
    nan = yt.new_full((B,), float("nan"))
    nxt = [None] * T  # (next valid value, its index) at or after t
    nv, ni = yt.new_zeros(B), yt.new_full((B,), 1e30)
    for t in reversed(range(T)):
        valid = ~torch.isnan(yt[t])
        nv = torch.where(valid, yt[t], nv)
        ni = torch.where(valid, float(t), ni)
        nxt[t] = (nv, ni)
    pv, pi, fprev = yt.new_zeros(B), yt.new_full((B,), -1e30), nan
    outs = ([], [], [])
    for t in range(T):
        yv = yt[t]
        valid = ~torch.isnan(yv)
        nv, ni = nxt[t]
        interior = (pi >= 0.0) & (ni < 1e30)
        w = (t - pi) / torch.clamp(ni - pi, min=1.0)
        interp = pv * (1.0 - w) + nv * w
        fill = torch.where(valid, yv, torch.where(interior, interp, nan))
        for out, v in zip(outs, (fill, fill - fprev, fprev)):
            out.append(v)
        pv = torch.where(valid, yv, pv)
        pi = torch.where(valid, float(t), pi)
        fprev = fill
    return tuple((torch.stack(o) if T else yt.new_empty(0, B))
                 for o, w in zip(outs, which) if w)


# ---------------------------------------------------------------------------
# multi-lag autocorrelation with the valid-sample mean
# ---------------------------------------------------------------------------


def autocorr(yt, num_lags: int):
    """Sample autocorrelation at lags ``1..num_lags`` of each series of the
    ``[T, B]`` panel -> ``[B, num_lags]`` (valid-sample mean and
    denominator; a constant or all-NaN series gives NaN)."""
    T, B = _panel_shape("yt", yt)
    if not autocorr_structural_ok(num_lags, T):
        raise ValueError(f"num_lags must be in (0, min(T, {_MAX_ACF_LAG})) "
                         f"= (0, {min(T, _MAX_ACF_LAG)}), got {num_lags}")
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    if not _on_cuda(dev):
        return autocorr_plain(yt, num_lags)
    out = yt.new_empty(num_lags, B)
    if B:
        _launch("autocorr", "sts_autocorr", "autocorr", dev, _ptr(yt),
                _ptr(out), B, T, num_lags)
    return out.t()


# csrc/autocorr.cu's tile route as built: series a block, threads a block,
# the largest register window, and the dynamic shared memory a block may
# have; _acf_chunk repeats sts_autocorr_route's rule with them
_ACF_TILE = 8
_ACF_THREADS = 256
_ACF_MAX_CAP = 32
_ACF_SMEM_MAX = 227 * 1024


def _acf_chunk(n_time: int, num_lags: int) -> int:
    """Chunk length of the autocorrelation kernel's tile route at ``(T,
    num_lags)`` (odd), or 0 where it takes the stream route (one thread a
    series, sequential sums)."""
    floats = (max(n_time * _ACF_TILE, (_ACF_MAX_CAP + 1) * _ACF_THREADS)
              + 2 * _ACF_THREADS)
    if num_lags > _ACF_MAX_CAP or 4 * floats > _ACF_SMEM_MAX:
        return 0
    chunks = _ACF_THREADS // _ACF_TILE
    return -(-n_time // chunks) | 1


def autocorr_plain(yt, num_lags: int):
    """Plain PyTorch version of :func:`autocorr`, in the kernel's summation
    order: on the tile route each series is cut into chunks of
    :func:`_acf_chunk` steps, every sum runs in time order inside a chunk
    and the chunks' partials add in chunk order; on the stream route one
    chunk spans the series.  The kernel fuses each lag product into its
    sum (a fused multiply-add) where this version rounds the product
    first."""
    T, B = yt.shape
    L = _acf_chunk(T, num_lags)
    chunks = _ACF_THREADS // _ACF_TILE if L else 1
    L = L or T
    valid = ~torch.isnan(yt)
    pad = yt.new_zeros(chunks * L - T, B)  # rows past T add nothing

    def by_chunk(x):  # [T, B] -> [chunks, L, B]
        return torch.cat([x, pad]).view(chunks, L, B)

    vc = by_chunk(valid.to(yt.dtype))
    yc = by_chunk(torch.where(valid, yt, 0.0))
    n, s = yt.new_zeros(chunks, B), yt.new_zeros(chunks, B)
    for j in range(L):
        n, s = n + vc[:, j], s + yc[:, j]
    n_all, s_all = yt.new_zeros(B), yt.new_zeros(B)
    for c in range(chunks):
        n_all, s_all = n_all + n[c], s_all + s[c]
    mean = s_all / torch.clamp(n_all, min=1.0)
    d = torch.cat([torch.where(valid, yt - mean, 0.0), pad])
    dc = d.view(chunks, L, B)
    lagged = torch.cat([yt.new_zeros(num_lags, B), d])  # row r + nl: d_r
    # row of d_{t-1-k} in `lagged` for t = c L + j, less j
    back = (torch.arange(chunks, device=yt.device)[None, :] * L + num_lags
            - 1 - torch.arange(num_lags, device=yt.device)[:, None])
    a0 = yt.new_zeros(chunks, B)
    acc = yt.new_zeros(num_lags, chunks, B)
    for j in range(L):
        dj = dc[:, j]
        a0 = a0 + dj * dj
        acc = acc + dj[None] * lagged[back + j]
    num, den = yt.new_zeros(num_lags, B), yt.new_zeros(B)
    for c in range(chunks):
        num, den = num + acc[:, c], den + a0[c]
    return (num / den).t()


# ---------------------------------------------------------------------------
# GARCH(1,1): h_t = omega + alpha r_{t-1}^2 + beta h_{t-1}, and its adjoint
# ---------------------------------------------------------------------------

_GARCH_MODES = {"e": 0, "sum": 1, "both": 2, "last": 3}
_H_MIN = 1e-12
_TWO_PI = 2.0 * math.pi


def garch_fwd(rt, params, h0, zb, mode: str):
    """GARCH(1,1) variances of the ``[T, B]`` returns ``rt`` under ``params
    [B, 3]`` (``[omega, alpha, beta]``), start variance ``h0 [B]`` and
    first live step ``zb [B]`` (before it ``h = h0``; at it ``h0`` stands
    in for the unobserved squared return).

    ``mode``: ``"e"`` -> ``h [T, B]``; ``"sum"`` -> the per-series Gaussian
    sum ``sum_live log(2 pi h) + r^2 / h`` ``[B]``; ``"both"`` -> ``(h,
    sum)`` with the sum bitwise equal to ``"sum"``; ``"last"`` -> ``h`` at
    the last step ``[B]``.
    """
    if mode not in _GARCH_MODES:
        raise ValueError(f"unknown garch_fwd mode {mode!r}")
    T, B = _panel_shape("rt", rt)
    dev = rt.device
    _check("rt", rt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("h0", h0, (B,), dev)
    _check("zb", zb, (B,), dev)
    if not _on_cuda(dev):
        return garch_fwd_plain(rt, params, h0, zb, mode)
    h = torch.empty_like(rt) if mode in ("e", "both") else None
    ll = rt.new_empty(B) if mode in ("sum", "both") else None
    hl = rt.new_empty(B) if mode == "last" else None
    if B:
        par_t = params.t().contiguous()
        _launch("garch", "sts_garch_fwd", "garch_fwd", dev, _ptr(rt),
                _ptr(par_t), _ptr(h0), _ptr(zb), _ptr(h), _ptr(ll), _ptr(hl),
                B, T, _GARCH_MODES[mode])
    return {"e": h, "sum": ll, "both": (h, ll), "last": hl}[mode]


def garch_fwd_plain(rt, params, h0, zb, mode: str):
    """Plain PyTorch version of :func:`garch_fwd` (same recursion, same
    summation order)."""
    T, B = rt.shape
    omega, alpha, beta = params.unbind(1)
    hprev, r2p, acc = h0, rt.new_zeros(B), rt.new_zeros(B)
    hs = []
    for t in range(T):
        r2 = rt[t] * rt[t]
        r2in = torch.where(zb == t, h0, r2p)
        live = zb <= t
        hv = torch.where(live, omega + alpha * r2in + beta * hprev, h0)
        if mode in ("e", "both"):
            hs.append(hv)
        if mode in ("sum", "both"):
            hc = torch.clamp(hv, min=_H_MIN)
            acc = acc + torch.where(live, torch.log(_TWO_PI * hc) + r2 / hc,
                                    0.0)
        hprev, r2p = hv, r2
    h = (torch.stack(hs) if T else rt.new_empty(0, B)) \
        if mode in ("e", "both") else None
    return {"e": h, "sum": acc, "both": (h, acc), "last": hprev}[mode]


def garch_bwd(rt, params, h0, zb, ht, g, want_gr: bool = False):
    """Adjoint of :func:`garch_fwd` -> ``(gparams [B, 3], gh0 [B], gr [T, B]
    or None)``.

    ``ht`` is the forward's variance panel.  ``g`` is either a cotangent of
    ``h`` (``[T, B]``) or, for the likelihood sum, its per-series cotangent
    ``[B]`` (the per-step cotangent ``g (1/h - r^2/h^2)`` is formed in the
    kernel, zero through the 1e-12 clamp, and the sum's direct dependence
    on ``r`` joins ``gr``).  ``gr``, the cotangent of the returns ``rt``,
    is computed only with ``want_gr``.
    """
    T, B = _panel_shape("rt", rt)
    dev = rt.device
    _check("rt", rt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("h0", h0, (B,), dev)
    _check("zb", zb, (B,), dev)
    _check("ht", ht, (T, B), dev)
    g_is_ll = g.dim() == 1
    _check("g", g, (B,) if g_is_ll else (T, B), dev)
    if not _on_cuda(dev):
        return garch_bwd_plain(rt, params, h0, zb, ht, g, want_gr)
    gpar = rt.new_empty(3, B)
    gh0 = rt.new_empty(B)
    gr = torch.empty_like(rt) if want_gr else None
    if B:
        par_t = params.t().contiguous()
        _launch("garch", "sts_garch_bwd", "garch_bwd", dev, _ptr(rt),
                _ptr(par_t), _ptr(h0), _ptr(zb), _ptr(ht), _ptr(g),
                _ptr(gpar), _ptr(gh0), _ptr(gr), B, T, int(g_is_ll))
    return gpar.t(), gh0, gr


def garch_bwd_plain(rt, params, h0, zb, ht, g, want_gr: bool = False):
    """Plain PyTorch version of :func:`garch_bwd` (the kernel's order: t
    descending; ``1 / hc`` formed once, as the kernel forms it)."""
    T, B = rt.shape
    g_is_ll = g.dim() == 1
    alpha, beta = params[:, 1], params[:, 2]
    zero = rt.new_zeros(B)
    lam_next, dw, da, db, dh0 = zero, zero, zero, zero, zero
    grs = [None] * T
    for t in reversed(range(T)):
        rv, hv = rt[t], ht[t]
        rp = rt[t - 1] if t >= 1 else zero
        hp = ht[t - 1] if t >= 1 else h0
        live = zb <= t
        hc = torch.clamp(hv, min=_H_MIN)
        inv = 1.0 / hc
        if g_is_ll:
            gt = torch.where(live & (hv >= _H_MIN),
                             g * (inv - (rv * rv) * (inv * inv)), 0.0)
        else:
            gt = g[t]
        next_live = (zb < t + 1) & (t + 1 < T)
        gr2 = torch.where(next_live, alpha * lam_next, 0.0)
        lam = torch.where(live, gt + beta * lam_next, 0.0)
        dh0 = dh0 + torch.where(live, 0.0, gt)
        seed = zb == t
        dw = dw + lam
        da = da + lam * torch.where(seed, h0, rp * rp)
        db = db + lam * hp
        dh0 = dh0 + torch.where(live & seed, alpha * lam, 0.0)
        dh0 = dh0 + torch.where(live & (zb > t - 1), beta * lam, 0.0)
        if want_gr:
            v = gr2 * 2.0 * rv
            if g_is_ll:
                v = v + torch.where(live, g * 2.0 * rv * inv, 0.0)
            grs[t] = v
        lam_next = lam
    gr = None
    if want_gr:
        gr = torch.stack(grs) if T else rt.new_empty(0, B)
    return torch.stack([dw, da, db], dim=1), dh0, gr


# ---------------------------------------------------------------------------
# EWMA: s_t = alpha x_t + (1 - alpha) s_{t-1}, seeded s_zb = x_zb
# ---------------------------------------------------------------------------

_EWMA_MODES = {"e": 0, "sum": 1, "both": 2}


def ewma_fwd(xt, alpha, zb, mode: str):
    """EWMA smoothing of the ``[T, B]`` panel ``xt`` (zero before each
    series' first live step ``zb [B]``) under ``alpha [B]``: ``s`` is 0
    before ``zb``, ``x_zb`` at it, ``alpha x_t + (1 - alpha) s_{t-1}``
    after.

    ``mode``: ``"e"`` -> ``s [T, B]``; ``"sum"`` -> the one-step-ahead SSE
    ``sum_{t > zb} (x_t - s_{t-1})^2`` ``[B]``; ``"both"`` -> ``(s, sse)``
    with the SSE bitwise equal to ``"sum"``.
    """
    if mode not in _EWMA_MODES:
        raise ValueError(f"unknown ewma_fwd mode {mode!r}")
    T, B = _panel_shape("xt", xt)
    dev = xt.device
    _check("xt", xt, (T, B), dev)
    _check("alpha", alpha, (B,), dev)
    _check("zb", zb, (B,), dev)
    if not _on_cuda(dev):
        return ewma_fwd_plain(xt, alpha, zb, mode)
    s = torch.empty_like(xt) if mode != "sum" else None
    sse = xt.new_empty(B) if mode != "e" else None
    if B:
        _launch("ewma", "sts_ewma_fwd", "ewma_fwd", dev, _ptr(xt),
                _ptr(alpha), _ptr(zb), _ptr(s), _ptr(sse), B, T,
                _EWMA_MODES[mode])
    return {"e": s, "sum": sse, "both": (s, sse)}[mode]


def ewma_fwd_plain(xt, alpha, zb, mode: str):
    """Plain PyTorch version of :func:`ewma_fwd` (the kernel's operations,
    each rounded once, in its order)."""
    T, B = xt.shape
    sp, acc = xt.new_zeros(B), xt.new_zeros(B)
    ss = []
    for t in range(T):
        xv = xt[t]
        s = torch.where(zb == t, xv, alpha * xv + (1.0 - alpha) * sp)
        s = torch.where(zb <= t, s, 0.0)
        e = torch.where(zb < t, xv - sp, 0.0)
        acc = acc + e * e
        if mode != "sum":
            ss.append(s)
        sp = s
    s = (torch.stack(ss) if T else xt.new_empty(0, B)) \
        if mode != "sum" else None
    return {"e": s, "sum": acc, "both": (s, acc)}[mode]


def ewma_bwd(xt, st, alpha, zb, g, want_gx: bool = False):
    """Adjoint of :func:`ewma_fwd` -> ``(galpha [B], gx [T, B] or None)``.

    ``st`` is the forward's smoothed panel.  ``g`` is either a cotangent of
    ``s`` (``[T, B]``) or, for the SSE, its per-series cotangent ``[B]``
    (the per-step cotangent ``-2 g err_{t+1}`` and the SSE's direct
    dependence on ``x`` are formed in the kernel).  ``gx``, the cotangent
    of ``xt``, is computed only with ``want_gx``.
    """
    T, B = _panel_shape("xt", xt)
    dev = xt.device
    _check("xt", xt, (T, B), dev)
    _check("st", st, (T, B), dev)
    _check("alpha", alpha, (B,), dev)
    _check("zb", zb, (B,), dev)
    g_is_sse = g.dim() == 1
    _check("g", g, (B,) if g_is_sse else (T, B), dev)
    if not _on_cuda(dev):
        return ewma_bwd_plain(xt, st, alpha, zb, g, want_gx)
    ga = xt.new_empty(B)
    gx = torch.empty_like(xt) if want_gx else None
    if B:
        _launch("ewma", "sts_ewma_bwd", "ewma_bwd", dev, _ptr(xt), _ptr(st),
                _ptr(alpha), _ptr(zb), _ptr(g), _ptr(ga), _ptr(gx), B, T,
                int(g_is_sse))
    return ga, gx


def ewma_bwd_plain(xt, st, alpha, zb, g, want_gx: bool = False):
    """Plain PyTorch version of :func:`ewma_bwd` (the kernel's order: t
    descending)."""
    T, B = xt.shape
    g_is_sse = g.dim() == 1
    zero = xt.new_zeros(B)
    lam_next, da = zero, zero
    gxs = [None] * T
    for t in reversed(range(T)):
        xv = xt[t]
        sp = st[t - 1] if t >= 1 else zero
        live, past = zb <= t, zb < t
        if g_is_sse:
            en = (torch.where(zb < t + 1, xt[t + 1] - st[t], 0.0)
                  if t + 1 < T else zero)
            gt = -2.0 * en * g
        else:
            gt = g[t]
        lam = torch.where(live, gt + (1.0 - alpha) * lam_next, 0.0)
        err = xv - sp
        da = da + torch.where(live & past, lam * err, 0.0)
        if want_gx:
            v = torch.where(live, torch.where(past, alpha * lam, lam), 0.0)
            if g_is_sse:
                v = v + torch.where(past, 2.0 * err * g, 0.0)
            gxs[t] = v
        lam_next = torch.where(past, lam, 0.0)
    gx = None
    if want_gx:
        gx = torch.stack(gxs) if T else xt.new_empty(0, B)
    return da, gx


# ---------------------------------------------------------------------------
# Holt-Winters: level / trend / seasonal-ring recursion, and its adjoint
# ---------------------------------------------------------------------------

_HW_EPS = 1e-12


def hw_fwd(yt, params, l0, t0, s0r, zb, period: int, mult: bool,
           save_resid: bool = False):
    """Holt-Winters one-step-ahead SSE ``[B]`` of the ``[T, B]`` panel
    ``yt`` (zero before each series' first live step ``zb``) under
    ``params [B, 3]`` (``[alpha, beta, gamma]``), additive or
    multiplicative (``mult``), from the seeds ``l0``, ``t0 [B]`` and the
    pre-rotated seasonal ring ``s0r [B, period]`` (slot ``t mod period``
    is the seasonal value step ``t`` reads; :func:`hw_seeds`).

    The state moves only from ``zb`` on; the error ``e_t`` is live from
    ``zb + period``.  ``save_resid`` -> ``(e, L, T, S_old, sse)``: the
    errors, the level and trend after each step and the seasonal value each
    step read, all ``[T, B]``, with the SSE bitwise equal to the value-only
    call.
    """
    _hw_check_period(period)
    T, B = _panel_shape("yt", yt)
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("l0", l0, (B,), dev)
    _check("t0", t0, (B,), dev)
    _check("s0r", s0r, (B, period), dev)
    _check("zb", zb, (B,), dev)
    if not _on_cuda(dev):
        return hw_fwd_plain(yt, params, l0, t0, s0r, zb, period, mult,
                            save_resid)
    sse = yt.new_empty(B)
    outs = [torch.empty_like(yt) for _ in range(4)] if save_resid else None
    if B:
        _launch_call("hw", "hw_fwd", dev, lambda lib, st: _hw_fwd_call(
            lib, st, yt, params, l0, t0, s0r, zb, period, mult, sse, outs))
    return (*outs, sse) if save_resid else sse


def _hw_fwd_call(lib, stream, yt, params, l0, t0, s0r, zb, period: int,
                 mult: bool, sse, outs=None, walked=None) -> int:
    """Launch the Holt-Winters forward of ``lib`` (a build of ``hw.cu``) on
    ``stream``, inputs as :func:`hw_fwd` takes them: the SSE into ``sse
    [B]``; with ``outs`` (e, L, T, S_old, each ``[T, B]``) the
    ``save_resid`` mode; ``walked`` (int32 ``[B]``), when given, gets 1
    where the kernel redid a series with ``__fdiv_rn``.  Returns the CUDA
    error.  The one place that packs ``sts_hw_fwd``'s arguments, for every
    build that is called."""
    T, B = yt.shape
    # the kernel reads params and s0r in their [B, k] rows; the global
    # route's ring runs in an [period, B] scratch
    ring = (None if lib.sts_hw_ring_in_registers(period)
            else yt.new_empty(period, B))
    save = outs is not None
    return lib.sts_hw_fwd(
        _ptr(yt), _ptr(params), _ptr(l0), _ptr(t0), _ptr(s0r), _ptr(ring),
        _ptr(zb), *(_ptr(o) for o in (outs if save else (None,) * 4)),
        _ptr(sse), _ptr(walked), B, T, period, int(mult), int(save), stream)


def hw_fwd_plain(yt, params, l0, t0, s0r, zb, period: int, mult: bool,
                 save_resid: bool = False):
    """Plain PyTorch version of :func:`hw_fwd` (the kernel's operations,
    each rounded once, in its order; the ring a list indexed by t mod m)."""
    T, B = yt.shape
    a, b, g = params.unbind(1)
    oa, ob, og = 1.0 - a, 1.0 - b, 1.0 - g
    ring = list(s0r.unbind(1))
    level, trend, acc = l0, t0, yt.new_zeros(B)
    zm = zb + period
    outs = ([], [], [], [])
    for t in range(T):
        yv = yt[t]
        slot = t % period
        s = ring[slot]
        lt = level + trend
        if mult:
            pred = lt * s
            nl = a * yv / torch.clamp(s, min=_HW_EPS) + oa * lt
            snew = g * yv / torch.clamp(nl, min=_HW_EPS) + og * s
        else:
            pred = lt + s
            nl = a * (yv - s) + oa * lt
            snew = g * (yv - nl) + og * s
        nt = b * (nl - level) + ob * trend
        e = torch.where(zm <= t, yv - pred, 0.0)
        acc = acc + e * e
        live = zb <= t
        level = torch.where(live, nl, level)
        trend = torch.where(live, nt, trend)
        ring[slot] = torch.where(live, snew, s)
        if save_resid:
            for out, v in zip(outs, (e, level, trend, s)):
                out.append(v)
    if not save_resid:
        return acc
    return (*((torch.stack(o) if T else yt.new_empty(0, B)) for o in outs),
            acc)


def hw_bwd(yt, params, l0, t0, zb, lv, tr, so, e, g, period: int,
           mult: bool):
    """Adjoint of :func:`hw_fwd`'s errors -> ``gparams [B, 3]``.

    ``lv``, ``tr``, ``so`` (and ``e``) are the trajectories of the forward
    with ``save_resid``.  ``g`` is either a cotangent of the errors ``[T,
    B]`` (``e`` is then not read and may be None) or, for the SSE, its
    per-series cotangent ``[B]`` (the per-step ``2 e_t g`` is formed in
    the kernel).  The seeds are constants: no cotangent flows to them.
    """
    _hw_check_period(period)
    T, B = _panel_shape("yt", yt)
    dev = yt.device
    _check("yt", yt, (T, B), dev)
    _check("params", params, (B, 3), dev)
    _check("l0", l0, (B,), dev)
    _check("t0", t0, (B,), dev)
    _check("zb", zb, (B,), dev)
    for name, x in (("lv", lv), ("tr", tr), ("so", so)):
        _check(name, x, (T, B), dev)
    g_is_sse = g.dim() == 1
    if g_is_sse:
        _check("e", e, (T, B), dev)
    _check("g", g, (B,) if g_is_sse else (T, B), dev)
    if not _on_cuda(dev):
        return hw_bwd_plain(yt, params, l0, t0, zb, lv, tr, so, e, g, period,
                            mult)
    rho = None if hw_ring_in_registers(period) else yt.new_zeros(period, B)
    gpar = yt.new_empty(3, B)
    if B:
        gpan, gbar = (e, g) if g_is_sse else (g, None)
        _launch("hw", "sts_hw_bwd", "hw_bwd", dev, _ptr(yt), _ptr(params),
                _ptr(l0), _ptr(t0), _ptr(zb), _ptr(lv), _ptr(tr), _ptr(so),
                _ptr(gpan), _ptr(gbar), _ptr(rho), _ptr(gpar), B, T, period,
                int(mult))
    return gpar.t()


def hw_bwd_plain(yt, params, l0, t0, zb, lv, tr, so, e, g, period: int,
                 mult: bool):
    """Plain PyTorch version of :func:`hw_bwd` (the kernel's order: t
    descending; the adjoint ring a list indexed by t mod m)."""
    T, B = yt.shape
    a, b, gm = params.unbind(1)
    oa, ob, og = 1.0 - a, 1.0 - b, 1.0 - gm
    g_is_sse = g.dim() == 1
    zero = yt.new_zeros(B)
    rho = [zero] * period
    lam_l, lam_t, da, db, dg = zero, zero, zero, zero, zero
    zm = zb + period
    for t in reversed(range(T)):
        slot = t % period
        us, ul, ut = rho[slot], lam_l, lam_t
        gt = 2.0 * e[t] * g if g_is_sse else g[t]
        gp = torch.where(zm <= t, -gt, 0.0)
        lp = lv[t - 1] if t >= 1 else l0
        tp = tr[t - 1] if t >= 1 else t0
        s, lt, yv = so[t], lv[t], yt[t]
        if mult:
            sc = torch.clamp(s, min=_HW_EPS)
            ltc = torch.clamp(lt, min=_HW_EPS)
            s_pass = (s >= _HW_EPS).to(yt.dtype)
            l_pass = (lt >= _HW_EPS).to(yt.dtype)
            vl = ul + b * ut - gm * (yv / (ltc * ltc)) * us * l_pass
            da_t = (yv / sc - lp - tp) * vl
            dg_t = (yv / ltc - s) * us
            new_l = -b * ut + oa * vl + s * gp
            new_t = ob * ut + oa * vl + s * gp
            rn = og * us - a * (yv / (sc * sc)) * vl * s_pass + (lp + tp) * gp
        else:
            vl = ul + b * ut - gm * us
            da_t = (yv - s - lp - tp) * vl
            dg_t = (yv - lt - s) * us
            new_l = -b * ut + oa * vl + gp
            new_t = ob * ut + oa * vl + gp
            rn = og * us - a * vl + gp
        db_t = (lt - lp - tp) * ut
        live = zb <= t
        da = da + torch.where(live, da_t, 0.0)
        db = db + torch.where(live, db_t, 0.0)
        dg = dg + torch.where(live, dg_t, 0.0)
        lam_l = torch.where(live, new_l, ul)
        lam_t = torch.where(live, new_t, ut)
        rho[slot] = torch.where(live, rn, us)
    return torch.stack([da, db, dg], dim=1)


# ---------------------------------------------------------------------------
# entry points (the reference's signatures, without ``interpret``)
# ---------------------------------------------------------------------------


class _CssSSE(torch.autograd.Function):
    """Per-series CSS sum of squares ``[B]`` of the time-major panel.

    Forward runs ``both`` (saving the errors) when a gradient is wanted and
    ``sum`` otherwise; the two SSEs are bitwise equal.  Backward is the
    adjoint kernel fed the per-series cotangent directly; the data
    cotangent is computed only when the data requires a gradient."""

    @staticmethod
    def forward(ctx, params, yt, zb, p, q, t_limit, save, lags):
        ctx.pq = (p, q, t_limit, lags)
        if not save:
            return css_fwd(yt, params, zb, p, q, "sum", t_limit, lags)
        e, sse = css_fwd(yt, params, zb, p, q, "both", t_limit, lags)
        ctx.save_for_backward(params, yt, zb, e)
        return sse

    @staticmethod
    def backward(ctx, gbar):
        params, yt, zb, e = ctx.saved_tensors
        p, q, t_limit, lags = ctx.pq
        want_gy = ctx.needs_input_grad[1]
        gpar, gy = css_bwd(yt, e, params, zb, gbar.contiguous(), p, q,
                           want_gy, t_limit, lags)
        return (gpar if ctx.needs_input_grad[0] else None, gy,
                None, None, None, None, None, None)


class _CssErrors(torch.autograd.Function):
    """CSS errors ``[T, B]`` of the time-major panel, differentiable in the
    parameters and the data through the adjoint kernel."""

    @staticmethod
    def forward(ctx, params, yt, zb, p, q):
        ctx.pq = (p, q)
        e = css_fwd(yt, params, zb, p, q, "e")
        ctx.save_for_backward(params, yt, zb, e)
        return e

    @staticmethod
    def backward(ctx, g):
        params, yt, zb, e = ctx.saved_tensors
        p, q = ctx.pq
        gpar, gy = css_bwd(yt, e, params, zb, g.contiguous(), p, q,
                           ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gy, None, None,
                None)


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def css_errors(p: int, q: int, params, yd, zb):
    """Batched ARMA(p, q) CSS errors ``[B, T]`` (natural layout).

    ``params [B, 1+p+q]`` rows ``[c, phi, theta]`` (pass ``c = 0`` without
    an intercept); ``yd [B, T]`` with any invalid prefix already zeroed;
    ``zb [B]`` float: errors before it are zero.  Differentiable in
    ``params`` and ``yd``."""
    return _CssErrors.apply(params, time_major(yd), zb, p, q).t()


def css_last_errors(p: int, q: int, params, yd, zb):
    """The last ``q`` CSS errors ``[B, q]`` (oldest first): the forecast's
    carry, from a read-only pass that writes O(B q).  Not differentiable."""
    if q == 0:
        return yd.new_zeros(yd.shape[0], 0)
    if yd.shape[1] < q:
        raise ValueError(f"series length {yd.shape[1]} < q={q}")
    return css_fwd(time_major(yd), params, zb, p, q, "tail")


def kernel_params(params, include_intercept: bool):
    if include_intercept:
        return params
    # the kernel layout always carries an intercept slot
    return torch.cat([params.new_zeros(params.shape[0], 1), params], dim=1)


def css_sse_folded(params, yt, zb, p: int, q: int, t_limit=None,
                   lags=None):
    """Per-series CSS sum of squares ``[B]`` of a panel in the kernels'
    layout, for kernel-layout ``params [B, 1+p+q]`` and conditioning start
    ``zb [B]``.  Differentiable in ``params`` (and in ``yt``) through the
    adjoint kernel; the seasonal and grid fits call it with their expanded
    lag coefficients and their structural ``lags`` (:func:`css_fwd`)."""
    t_limit = yt.shape[0] if t_limit is None else int(t_limit)
    return _CssSSE.apply(params, yt, zb, p, q, t_limit,
                         _needs_grad(params, yt), _css_lags(p, q, lags))


def css_neg_loglik_folded(params, yt, zb, n: int, order,
                          include_intercept: bool, n_valid=None):
    """Batched CSS negative log-likelihood ``[B]`` from a panel already in
    the kernels' layout (:func:`css_prefold`); matches
    :func:`css_neg_loglik` exactly.  Differentiable in ``params`` (and in
    ``yt``) through the adjoint kernel."""
    p, _, q = order
    b = params.shape[0]
    nv = (torch.full((b,), n, dtype=params.dtype, device=params.device)
          if n_valid is None else n_valid.to(params.dtype))
    pk = kernel_params(params, include_intercept).contiguous()
    css = css_sse_folded(pk, yt, zb, p, q, n)
    n_eff = nv - p
    sigma2 = css / n_eff
    return 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)


def css_neg_loglik(params, yd, order, include_intercept: bool,
                   n_valid=None):
    """Batched CSS negative log-likelihood ``[B]`` of the ``[B, T]`` panel
    ``yd`` (matches ``models.arima.css_neg_loglik`` row by row)."""
    yt, zb = css_prefold(yd, order, n_valid)
    return css_neg_loglik_folded(params, yt, zb, yd.shape[1], order,
                                 include_intercept, n_valid)


def _solve_moments(acc, ncols: int, ridge: float = 1e-8):
    """``[B, nacc]`` moment rows -> ridge-stabilized OLS solutions."""
    from ..utils.linalg import ridge_solve

    b = acc.shape[0]
    XtX = acc.new_empty(b, ncols, ncols)
    r = 0
    for a in range(ncols):
        for c in range(a, ncols):
            XtX[:, a, c] = acc[:, r]
            XtX[:, c, a] = acc[:, r]
            r += 1
    return ridge_solve(XtX, acc[:, r:r + ncols], ridge)


def hr_init(yd, order, include_intercept: bool, n_valid=None, *, yt=None):
    """Batched Hannan-Rissanen initial values ``[B, k]`` from two moment
    sweeps (stage-1 AR(m) -> solve -> stage 2 with residuals rebuilt on the
    fly -> solve); the same weighted normal equations as
    ``models.arima.hannan_rissanen_batched``.

    ``yd``: differenced ``[B, T]`` panel with the invalid prefix zeroed;
    ``yt``: optionally that panel already time-major (:func:`css_prefold`),
    so a fit converts its panel once.
    """
    p, _, q = order
    if not hr_structural_ok(p, q):
        raise ValueError(f"HR moment kernel supports p, q <= 8 (got {p}, {q})")
    b, t = yd.shape
    m = min(p + q + 1, max(t // 4, 1))
    nv = (torch.full((b,), t, dtype=torch.int32, device=yd.device)
          if n_valid is None else n_valid)
    zb = (t - nv).to(yd.dtype)
    if yt is None:
        yt = time_major(yd)
    acc1 = hr_moments(yt, zb, m, 0, True, m)
    beta1 = _solve_moments(acc1, m + 1)
    ncols2 = int(include_intercept) + p + q
    if ncols2 == 0:
        return yd.new_zeros(b, 0)
    acc2 = hr_moments(yt, zb, p, q, include_intercept, m + q, m,
                      beta1.contiguous())
    return _solve_moments(acc2, ncols2)


# -- fill chain and autocorrelation (forward-only transforms) ---------------


def _chain_flags(outputs) -> tuple:
    outputs = tuple(outputs)
    if not outputs or any(o not in CHAIN_OUTPUTS for o in outputs):
        raise ValueError(f"outputs must be a non-empty subset of "
                         f"{CHAIN_OUTPUTS}, got {outputs!r}")
    return outputs, tuple(o in outputs for o in CHAIN_OUTPUTS)


def fill_linear_chain_folded(fp: FoldedPanel, outputs=CHAIN_OUTPUTS):
    """Fill chain on a resident :class:`~.layout.FoldedPanel`, computing
    ONLY the requested outputs -> a tuple of folded panels in the order of
    ``outputs`` (an ordered subset of ``("filled", "diff", "lag")``)."""
    outputs, which = _chain_flags(outputs)
    outs = fill_chain(fp.data, which)
    by_name = dict(zip([o for o, w in zip(CHAIN_OUTPUTS, which) if w], outs))
    return tuple(FoldedPanel(by_name[o], fp.b, fp.t) for o in outputs)


def fill_linear_chain(y):
    """Fill chain on a ``[B, T]`` panel -> ``(filled, lag-1 difference,
    lag-1 shift)``, each ``[B, T]`` (views of time-major storage).

    Matches ``fill_linear``, ``differences_at_lag(., 1)`` and ``lag(., 1)``
    composed: edge NaNs survive the fill; position 0 of the difference and
    of the shift is NaN."""
    return tuple(o.t() for o in fill_chain(time_major(y)))


def fill_linear(y):
    """Linear-interpolation fill ``[B, T]`` (the fill output only)."""
    return fill_chain(time_major(y), (True, False, False))[0].t()


def batch_autocorr(y, num_lags: int):
    """Sample autocorrelation ``[B, num_lags]`` of a ``[B, T]`` panel;
    matches ``univariate.autocorr`` row by row (valid-sample mean and
    denominator)."""
    return autocorr(time_major(y), num_lags)


def batch_autocorr_folded(fp: FoldedPanel, num_lags: int):
    """:func:`batch_autocorr` on a resident :class:`~.layout.FoldedPanel`,
    with no layout conversion."""
    return autocorr(fp.data, num_lags)


# -- GARCH(1,1) objective ----------------------------------------------------


class _GarchH(torch.autograd.Function):
    """Conditional variances ``[T, B]`` of the time-major returns,
    differentiable in the parameters, the returns and ``h0`` through the
    adjoint kernel (``zb`` is a constant)."""

    @staticmethod
    def forward(ctx, params, rt, h0, zb):
        h = garch_fwd(rt, params, h0, zb, "e")
        ctx.save_for_backward(params, rt, h0, zb, h)
        return h

    @staticmethod
    def backward(ctx, g):
        params, rt, h0, zb, h = ctx.saved_tensors
        gpar, gh0, gr = garch_bwd(rt, params, h0, zb, h, g.contiguous(),
                                  ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gr,
                gh0 if ctx.needs_input_grad[2] else None, None)


class _GarchLL(torch.autograd.Function):
    """Unscaled Gaussian log-likelihood sum ``[B]`` of the GARCH recursion,
    ``sum_live log(2 pi h_t) + r_t^2 / h_t``.

    Forward runs ``both`` (saving the variances) when a gradient is wanted
    and ``sum`` otherwise; the two sums are bitwise equal.  Backward is the
    adjoint kernel fed the per-series cotangent directly; the returns'
    cotangent is computed only when the returns require a gradient (the
    ARGARCH objective), and the ``h0`` cotangent flows on through PyTorch
    autograd into whatever computed ``h0``."""

    @staticmethod
    def forward(ctx, params, rt, h0, zb, save):
        if not save:
            return garch_fwd(rt, params, h0, zb, "sum")
        h, ll = garch_fwd(rt, params, h0, zb, "both")
        ctx.save_for_backward(params, rt, h0, zb, h)
        return ll

    @staticmethod
    def backward(ctx, gbar):
        params, rt, h0, zb, h = ctx.saved_tensors
        gpar, gh0, gr = garch_bwd(rt, params, h0, zb, h, gbar.contiguous(),
                                  ctx.needs_input_grad[1])
        return (gpar if ctx.needs_input_grad[0] else None, gr,
                gh0 if ctx.needs_input_grad[2] else None, None, None)


def garch_variances(params, r, h0, zb):
    """Batched GARCH(1,1) conditional variances ``[B, T]`` (a view of
    time-major storage).

    ``params``: ``[B, 3]`` rows ``[omega, alpha, beta]``; ``r``: ``[B, T]``
    returns with the invalid prefix zeroed; ``h0``: ``[B]`` start variance;
    ``zb``: ``[B]`` first live position.  Differentiable in ``params``,
    ``r`` and ``h0`` through the adjoint kernel (``zb`` is constant)."""
    zb = zb.to(r.dtype).contiguous()
    return _GarchH.apply(params.contiguous(), time_major(r),
                         h0.to(r.dtype).contiguous(), zb).t()


def garch_h0_folded(rzt, mask, nvf):
    """The start variance ``h0 [B]``: the masked sample variance of the
    time-major returns ``rzt`` (zero outside ``mask``, the ``[T, B]``
    valid span) over ``nvf`` valid steps.  Differentiable in ``rzt``."""
    mean = rzt.sum(0) / nvf
    return torch.where(mask, (rzt - mean) ** 2, 0.0).sum(0) / nvf


def garch_neg_loglik_folded(params, rzt, h0, zb):
    """GARCH(1,1) Gaussian negative log-likelihood ``[B]`` from time-major
    returns ``rzt`` (zero outside each valid span), the start variance
    ``h0`` and the first live step ``zb``; matches
    :func:`garch_neg_loglik`.  Differentiable in ``params``, ``rzt`` and
    ``h0`` through the adjoint kernel."""
    return 0.5 * _GarchLL.apply(params, rzt, h0, zb,
                                _needs_grad(params, rzt, h0))


def garch_prefold(r, n_valid=None):
    """A ``[B, T]`` returns panel in the GARCH kernels' layout -> ``(rzt,
    mask, nvf, zb)``: the time-major copy zeroed outside each right-aligned
    valid span, that span as a ``[T, B]`` mask, the clamped valid count and
    the first live step (float ``[B]``)."""
    b, n = r.shape
    nv = (torch.full((b,), n, dtype=torch.int32, device=r.device)
          if n_valid is None else n_valid.to(torch.int32))
    zb = (n - nv).to(r.dtype)
    mask = torch.arange(n, dtype=r.dtype, device=r.device)[:, None] \
        >= zb[None, :]
    rzt = time_major(r).masked_fill_(~mask, 0.0)  # a copy
    return rzt, mask, torch.clamp(nv, min=1).to(r.dtype), zb


def garch_neg_loglik(params, r, n_valid=None):
    """Batched GARCH(1,1) Gaussian negative log-likelihood ``[B]`` of the
    ``[B, T]`` returns ``r``.

    Matches ``models.garch.neg_log_likelihood`` row by row: h0 is the
    masked sample variance of the valid span, the prefix is dead, and the
    likelihood sums over valid steps.  Differentiable in ``params`` and
    (through the returns and the variance seed) in ``r``."""
    rzt, mask, nvf, zb = garch_prefold(r, n_valid)
    h0 = garch_h0_folded(rzt, mask, nvf)
    return garch_neg_loglik_folded(params.contiguous(), rzt, h0, zb)


# -- EWMA objective ----------------------------------------------------------


class _EwmaS(torch.autograd.Function):
    """Smoothed series ``[T, B]`` of the time-major panel, differentiable in
    ``alpha`` and the data through the adjoint kernel (the data cotangent is
    computed only when the data requires a gradient)."""

    @staticmethod
    def forward(ctx, alpha, xt, zb):
        s = ewma_fwd(xt, alpha, zb, "e")
        ctx.save_for_backward(alpha, xt, zb, s)
        return s

    @staticmethod
    def backward(ctx, g):
        alpha, xt, zb, s = ctx.saved_tensors
        ga, gx = ewma_bwd(xt, s, alpha, zb, g.contiguous(),
                          ctx.needs_input_grad[1])
        return ga if ctx.needs_input_grad[0] else None, gx, None


class _EwmaSSE(torch.autograd.Function):
    """One-step-ahead SSE ``[B]`` of the EWMA recursion.  Forward runs
    ``both`` (saving the smoothed series) when a gradient is wanted and
    ``sum`` otherwise; the two SSEs are bitwise equal.  Backward is the
    adjoint kernel fed the per-series cotangent directly."""

    @staticmethod
    def forward(ctx, alpha, xt, zb, save):
        if not save:
            return ewma_fwd(xt, alpha, zb, "sum")
        s, sse = ewma_fwd(xt, alpha, zb, "both")
        ctx.save_for_backward(alpha, xt, zb, s)
        return sse

    @staticmethod
    def backward(ctx, gbar):
        alpha, xt, zb, s = ctx.saved_tensors
        ga, gx = ewma_bwd(xt, s, alpha, zb, gbar.contiguous(),
                          ctx.needs_input_grad[1])
        return ga if ctx.needs_input_grad[0] else None, gx, None, None


def ewma_smooth(alpha, x, zb):
    """Batched EWMA smoothing ``[B, T]`` (a view of time-major storage).

    ``alpha``: ``[B]``; ``x``: ``[B, T]`` with the invalid prefix zeroed;
    ``zb``: ``[B]`` first live position.  Differentiable in ``alpha`` and
    ``x`` (the data cotangent is computed only when ``x`` requires one)."""
    return _EwmaS.apply(alpha.contiguous(), time_major(x),
                        zb.to(x.dtype).contiguous()).t()


def ewma_prefold(x, n_valid=None):
    """A ``[B, T]`` panel in the EWMA kernels' layout -> ``(xzt, zb)``: the
    time-major copy zeroed before each right-aligned valid span, and the
    span's first step (float ``[B]``).  Differentiable in ``x``."""
    b, n = x.shape
    nv = (torch.full((b,), n, dtype=torch.int32, device=x.device)
          if n_valid is None else n_valid.to(torch.int32))
    zb = (n - nv).to(x.dtype)
    mask = torch.arange(n, dtype=x.dtype, device=x.device)[:, None] \
        >= zb[None, :]
    return torch.where(mask, time_major(x), 0.0), zb


def ewma_sse_folded(alpha, xzt, zb):
    """:func:`ewma_sse` from a panel already in the kernels' layout
    (:func:`ewma_prefold`).  Differentiable in ``alpha`` and ``xzt``."""
    return _EwmaSSE.apply(alpha.contiguous(), xzt, zb,
                          _needs_grad(alpha, xzt))


def ewma_sse(alpha, x, n_valid=None):
    """Batched one-step-ahead EWMA SSE ``[B]`` of the ``[B, T]`` panel
    ``x`` (matches ``models.ewma.sse`` row by row).  Differentiable in
    ``alpha`` and ``x``."""
    xzt, zb = ewma_prefold(x, n_valid)
    return ewma_sse_folded(alpha, xzt, zb)


# -- Holt-Winters objective ----------------------------------------------------


class _HwSSE(torch.autograd.Function):
    """Holt-Winters one-step-ahead SSE ``[B]``, differentiable in the
    parameters (the seeds are constants of the objective).  Forward runs
    with ``save_resid`` (the trajectories the adjoint replays) when a
    gradient is wanted and value-only otherwise; the two SSEs are bitwise
    equal.  Backward is the adjoint kernel fed the per-series cotangent."""

    @staticmethod
    def forward(ctx, params, yt, l0, t0, s0r, zb, period, mult, save):
        if not save:
            return hw_fwd(yt, params, l0, t0, s0r, zb, period, mult)
        e, lv, tr, so, sse = hw_fwd(yt, params, l0, t0, s0r, zb, period,
                                    mult, True)
        ctx.save_for_backward(params, yt, l0, t0, zb, lv, tr, so, e)
        ctx.hw = (period, mult)
        return sse

    @staticmethod
    def backward(ctx, gbar):
        params, yt, l0, t0, zb, lv, tr, so, e = ctx.saved_tensors
        gpar = hw_bwd(yt, params, l0, t0, zb, lv, tr, so, e,
                      gbar.contiguous(), *ctx.hw)
        return (gpar,) + (None,) * 8


def hw_seeds(y, period: int, multiplicative: bool = False, n_valid=None):
    """Level / trend / seasonal-ring seeds for :func:`hw_sse_seeded` ->
    ``(l0, t0, s0r, zb)``.

    The first-two-valid-seasons scheme of ``models.holtwinters._init_state``
    (windows clamped into the series, as the reference's ``dynamic_slice``
    clamps them), with the seasonal ring PRE-ROTATED for the kernels'
    ``t mod m`` indexing: ``ring[p] = s0[(p - start) mod m]``.  The seeds
    depend on the data only: compute them once per fit.  ``n_valid=None``
    asserts a dense panel (every row starts at t = 0): static windows, no
    rotation, ``zb = 0``."""
    from ..models.holtwinters import _init_state

    b, t = y.shape
    if n_valid is None:
        l0, t0, s0 = _init_state(y, period, multiplicative)
        return l0, t0, s0, y.new_zeros(b)
    start = (t - n_valid).to(torch.long)
    l0, t0, s0 = _init_state(y, period, multiplicative, start)
    pos = (torch.arange(period, device=y.device)[None, :]
           - start[:, None]) % period
    return l0, t0, torch.gather(s0, 1, pos), start.to(y.dtype)


def hw_sse_folded(params, yt, seeds, period: int,
                  multiplicative: bool = False):
    """:func:`hw_sse_seeded` on a panel already time-major (``[T, B]``,
    invalid prefix zeroed): the fit-loop entry point.  Differentiable in
    ``params``."""
    l0, t0, s0r, zb = seeds
    return _HwSSE.apply(params.contiguous(), yt, l0, t0, s0r, zb, period,
                        bool(multiplicative), _needs_grad(params))


def hw_sse_seeded(params, y, seeds, period: int,
                  multiplicative: bool = False):
    """Batched Holt-Winters one-step-ahead SSE ``[B]`` of the ``[B, T]``
    panel ``y`` (invalid prefix zeroed) with precomputed :func:`hw_seeds`;
    matches ``models.holtwinters.sse`` row by row, additive and
    multiplicative.  Differentiable in ``params``."""
    return hw_sse_folded(params, time_major(y), seeds, period,
                         multiplicative)


def hw_sse(params, y, period: int, multiplicative: bool = False,
           n_valid=None):
    """One-shot entry: :func:`hw_seeds`, then :func:`hw_sse_seeded`."""
    _hw_check_period(period)
    seeds = hw_seeds(y, period, multiplicative, n_valid)
    return hw_sse_seeded(params, y, seeds, period, multiplicative)


def hw_additive_sse(params, y, period: int):
    """Additive dense-panel entry (kept for compatibility): see
    :func:`hw_sse`."""
    return hw_sse(params, y, period, False, None)

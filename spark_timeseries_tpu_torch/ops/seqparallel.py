"""Sequence (time-axis) parallelism (port of ``ops/seqparallel.py``).

On a 2-D ``(series, time)`` mesh one series' ``[time]`` axis is split
across the mesh's time cells, and the within-series reductions and scans
are rebuilt from per-cell work plus cross-cell combines.  The reference
runs each function under ``shard_map`` with named-axis collectives; here a
function receives its row group's time shards as a list of ``[keys_local,
time_local]`` tensors, one per time cell and each on its cell's device,
and the collectives are written out:

- ``psum`` is the sum of the shards' partials in shard order (a fixed
  order, no atomics), on the first shard's device;
- the ``ppermute`` halo is a slice of the left neighbour's shard, moved
  with ``.to()`` (a no-op when the cells share a device);
- ``all_gather`` is the list itself;
- the within-shard ``lax.associative_scan`` of the affine carries is a
  log-depth doubling (Hillis-Steele) scan in tensor ops, never a Python
  loop over time; its association differs from XLA's, so results agree
  with the reference to rounding, not bit for bit.

:func:`cell_map` is the port's ``shard_map``: it splits ``[keys, time]``
arguments into those cell blocks by a :class:`~..parallel.mesh.
PartitionSpec` each, runs the function once per series row group, and
joins the outputs on the mesh's first device.  The ``sp_*_sharded``
wrappers and the ``sp_*_fit`` fits bind it; the fits run the port's
batched L-BFGS with autograd through these objectives.  The reference's
time-sharded path calls no Pallas kernel, so this module is plain PyTorch
on whatever device the mesh names.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch

from .. import obs
from ..parallel.mesh import Mesh, PartitionSpec as P, SERIES_AXIS, TIME_AXIS

Order = Tuple[int, int, int]
Block = List[torch.Tensor]  # one row group's time shards, in time order


def _sp_fit_span(model: str, values):
    """Telemetry span for one time-sharded fit (free no-op when the plane
    is disabled).  The port compiles no programs, so the span carries no
    compile/execute phase."""
    return obs.span("sp_fit", model=model, keys=int(values.shape[0]),
                    n_time=int(values.shape[1]))


# ---------------------------------------------------------------------------
# Cross-shard combines
# ---------------------------------------------------------------------------


def _psum(parts) -> torch.Tensor:
    """Sum of per-shard partials in shard order, on the first shard's
    device."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part.to(total.device)
    return total


def _offsets(block: Block) -> list:
    """Global time position of each shard's first column."""
    out, t0 = [], 0
    for b in block:
        out.append(t0)
        t0 += b.shape[1]
    return out


def _gpos(t0: int, b: torch.Tensor) -> torch.Tensor:
    """Global time positions ``[1, tl]`` of shard ``b`` starting at t0."""
    return (t0 + torch.arange(b.shape[1], device=b.device))[None, :]


def _col(x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A per-series ``[keys]`` value as a ``[keys, 1]`` column on ``b``'s
    device."""
    return x.to(b.device)[:, None]


def sp_moments(block: Block) -> Dict[str, torch.Tensor]:
    """NaN-aware per-series count/mean/var across a time-sharded axis.

    ``block``: the row group's time shards.  Returns per-series
    ``[keys_local]`` stats on the first shard's device.
    """
    valid = [~torch.isnan(b) for b in block]
    n = _psum([v.sum(1) for v in valid])
    s = _psum([torch.where(v, b, 0.0).sum(1) for v, b in zip(valid, block)])
    mean = s / torch.clamp(n, min=1)
    ss = _psum([torch.where(v, (b - _col(mean, b)) ** 2, 0.0).sum(1)
                for v, b in zip(valid, block)])
    var = ss / torch.clamp(n - 1, min=1)
    return {"count": n, "mean": mean, "var": var}


def _halo_from_left(block: Block, halo: int) -> Block:
    """Each shard receives the previous shard's last ``halo`` columns
    (zeros for the first shard): the neighbour hand-off for lagged
    terms.  A halo wider than a shard would need more than one
    neighbour's columns and raises."""
    out = []
    for j, b in enumerate(block):
        if halo > b.shape[1]:
            raise ValueError(
                f"a lag reach of {halo} columns is wider than the "
                f"time-shard length {b.shape[1]}; use fewer time shards")
        if j == 0:
            out.append(b.new_zeros(b.shape[0], halo))
        else:
            out.append(block[j - 1][:, -halo:].to(b.device))
    return out


def _lags_from_left(block: Block, nlags: int) -> list:
    """For each shard, its columns ``x_{t-1} .. x_{t-nlags}`` through one
    ``nlags``-column halo (positions below global 0 read the first
    shard's zero halo)."""
    if nlags == 0:
        return [[] for _ in block]
    out = []
    for b, h in zip(block, _halo_from_left(block, nlags)):
        ext = torch.cat([h, b], dim=1)
        tl = b.shape[1]
        out.append([ext[:, nlags - i:nlags - i + tl]
                    for i in range(1, nlags + 1)])
    return out


def _shift1_from_left(block: Block) -> Block:
    """``x_{t-1}`` along the sharded time axis (global position 0 gets
    0)."""
    return [lags[0] for lags in _lags_from_left(block, 1)]


def sp_autocov(block: Block, max_lag: int) -> torch.Tensor:
    """Autocovariance at lags 1..max_lag of time-sharded series ->
    ``[keys_local, max_lag]``.  Cross-shard lagged products read a
    ``max_lag``-column halo from the left neighbour.  Assumes no NaNs
    (fill first)."""
    mean = sp_moments(block)["mean"]
    d = [b - _col(mean, b) for b in block]
    lags = _lags_from_left(d, max_lag)
    return torch.stack([_psum([(dj * lj[k - 1]).sum(1)
                               for dj, lj in zip(d, lags)])
                        for k in range(1, max_lag + 1)], dim=1)


def sp_autocorr(block: Block, max_lag: int) -> torch.Tensor:
    """Autocorrelation at lags 1..max_lag (matches ``univariate.autocorr``
    on unsharded data)."""
    mean = sp_moments(block)["mean"]
    d = [b - _col(mean, b) for b in block]
    denom = _psum([(dj * dj).sum(1) for dj in d])
    return sp_autocov(block, max_lag) / denom[:, None]


def sp_cumsum(block: Block) -> Block:
    """Cumulative sum along a time-sharded axis: each shard's local cumsum
    plus the sum of the totals of the shards before it."""
    local = [torch.cumsum(b, dim=1) for b in block]
    out = []
    for j, lj in enumerate(local):
        offset = torch.zeros_like(lj[:, -1:])
        for li in local[:j]:
            offset = offset + li[:, -1:].to(lj.device)
        out.append(lj + offset)
    return out


def sp_differences(block: Block, k_lag: int = 1) -> Block:
    """Lag-k differencing across shard boundaries via a halo; the first
    ``k_lag`` global positions are NaN (matches
    ``univariate.differences_at_lag``)."""
    out = []
    for t0, b, lags in zip(_offsets(block), block,
                           _lags_from_left(block, k_lag)):
        d = b - lags[k_lag - 1]
        out.append(torch.where(_gpos(t0, b) < k_lag, torch.nan, d))
    return out


def _affine_scan_local(m: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``s_t = m_t s_{t-1} + b_t`` along dim 1 from a
    zero carry -> ``(decay, p)`` with ``s_t = decay_t s_in + p_t``: a
    log-depth doubling scan (each level composes every element with the
    one ``off`` steps before it)."""
    off, t = 1, m.shape[1]
    while off < t:
        m, b = (torch.cat([m[:, :off], m[:, off:] * m[:, :-off]], dim=1),
                torch.cat([b[:, :off], b[:, off:] + m[:, off:] * b[:, :-off]],
                          dim=1))
        off *= 2
    return m, b


def _affine_scan_sharded(m_elem: Block, b_elem: Block) -> Block:
    """Inclusive scan of the affine recursion ``s_t = m_t * s_{t-1} + b_t``
    along a time-sharded axis, carry entering the global front = 0.

    Affine maps compose associatively, so both levels parallelize: inside
    a shard the doubling scan, across shards one tiny fold of each shard's
    composed exit pair (in shard order).  A global seed or dead prefix is
    encoded in the elements (``m = 0`` cuts the incoming carry).
    """
    scans = [_affine_scan_local(m, b) for m, b in zip(m_elem, b_elem)]
    out, carry = [], None
    for decay, p in scans:
        entering = (torch.zeros_like(p[:, -1]) if carry is None
                    else carry.to(p.device))
        out.append(decay * entering[:, None] + p)
        carry = out[-1][:, -1]
    return out


def _affine_scan_local_vec(A: torch.Tensor, b: torch.Tensor):
    """:func:`_affine_scan_local` for ``s`` in R^q: ``A [k, tl, q, q]``,
    ``b [k, tl, q]``, composing ``(A2, b2) o (A1, b1) = (A2 A1, b2 + A2
    b1)``."""
    off, t = 1, A.shape[1]
    while off < t:
        r = A[:, off:]
        A, b = (torch.cat([A[:, :off], r @ A[:, :-off]], dim=1),
                torch.cat([b[:, :off],
                           b[:, off:] + (r @ b[:, :-off, :, None])[..., 0]],
                          dim=1))
        off *= 2
    return A, b


def _affine_scan_sharded_vec(A_elem: Block, b_elem: Block) -> Block:
    """Vector generalization of :func:`_affine_scan_sharded`: inclusive
    scan of ``s_t = A_t s_{t-1} + b_t`` with ``s`` in R^q along a
    time-sharded axis, carry entering the global front = 0 (O(q^3) a
    composition: cheap for the small-q ARMA carries this serves)."""
    scans = [_affine_scan_local_vec(A, b) for A, b in zip(A_elem, b_elem)]
    out, carry = [], None
    for decay, pfx in scans:
        entering = (torch.zeros_like(pfx[:, -1]) if carry is None
                    else carry.to(pfx.device))
        out.append((decay @ entering[:, None, :, None])[..., 0] + pfx)
        carry = out[-1][:, -1]
    return out


def sp_ewma_smooth(block: Block, alpha: torch.Tensor) -> Block:
    """EWMA smoothing of time-sharded series (matches ``ewma.smooth`` on
    unsharded data; seeds ``s_0 = x_0``).  Every step is the affine map
    ``s -> (1-a) s + a x_t``; the global seed is ``(0, x_0)``.  ``alpha``:
    ``[keys_local]``.  Assumes dense data (fill first)."""
    ms, bs = [], []
    for t0, b in zip(_offsets(block), block):
        a = _col(alpha, b)
        seed = _gpos(t0, b) == 0
        ms.append(torch.where(seed, 0.0, (1.0 - a).expand_as(b)))
        bs.append(torch.where(seed, b, a * b))
    return _affine_scan_sharded(ms, bs)


def sp_ewma_sse(block: Block, alpha: torch.Tensor) -> torch.Tensor:
    """One-step-ahead EWMA SSE of time-sharded series ``[keys_local]``
    (matches ``ewma.sse`` on dense unsharded data): smoothing via the
    affine scan, the ``s_{t-1}`` lag via a 1-column halo, the sum over
    shards in order."""
    sprev = _shift1_from_left(sp_ewma_smooth(block, alpha))
    parts = []
    for t0, b, sp in zip(_offsets(block), block, sprev):
        err = torch.where(_gpos(t0, b) >= 1, b - sp, 0.0)
        parts.append((err * err).sum(1))
    return _psum(parts)


def sp_garch_neg_loglik(params: torch.Tensor, r: Block, h0: torch.Tensor,
                        start: int = 0) -> torch.Tensor:
    """Gaussian GARCH(1,1) negative log-likelihood on a time-sharded dense
    returns panel -> ``[keys_local]`` (matches ``models.garch.
    neg_log_likelihood``).

    ``params``: ``[keys_local, 3]`` natural rows ``[omega, alpha, beta]``;
    ``h0``: ``[keys_local]`` seed variance (it also stands in for the
    unobserved ``r_{start-1}^2``).  The variance recursion is affine in
    the carry, so it runs as :func:`_affine_scan_sharded`, the seed folded
    into the element at global position ``start`` (positions before it
    contribute nothing).
    """
    rsq = [x * x for x in r]
    ms, bs, gps = [], [], []
    for t0, x, rs, rsp in zip(_offsets(r), r, rsq, _shift1_from_left(rsq)):
        omega, alpha, beta = (_col(params[:, i], x) for i in range(3))
        h0c = _col(h0, x)
        gp = _gpos(t0, x)
        first = gp == start
        rsp = torch.where(first, h0c, rsp)
        b_el = omega + alpha * rsp
        # the seed step absorbs the carry: h_start = omega + (alpha+beta) h0
        b_el = torch.where(first, b_el + beta * h0c, b_el)
        bs.append(torch.where(gp < start, 0.0, b_el))
        ms.append(torch.where(gp <= start, 0.0, beta.expand_as(x)))
        gps.append(gp)
    parts = []
    for gp, rs, h in zip(gps, rsq, _affine_scan_sharded(ms, bs)):
        h = torch.clamp(h, min=1e-12)
        ll = torch.where(gp >= start, torch.log(2.0 * math.pi * h) + rs / h,
                         0.0)
        parts.append(ll.sum(1))
    return 0.5 * _psum(parts)


def sp_css_neg_loglik(params: torch.Tensor, yd: Block, d_dead: int,
                      p: int = 1, q: int = 1) -> torch.Tensor:
    """Conditional-sum-of-squares negative log-likelihood of ARMA(p, q) with
    intercept on a time-sharded differenced panel -> ``[keys_local]``.

    ``params``: ``[keys_local, 1 + p + q]`` rows ``[c, phi_1..p,
    theta_1..q]``; ``yd``: the differenced series on the ORIGINAL time grid
    with the first ``d_dead`` global positions zeroed.  Matches
    ``models.arima.css_neg_loglik`` with order (p, 0, q) on the trimmed
    vector.  The AR part is a p-column halo; the MA recursion is affine in
    its carry: scalar for q = 1, a companion-matrix carry for q > 1.
    Errors in the conditional prefix (the first p valid steps) are zeroed.
    """
    es_u, lives = [], []
    for t0, y, lags in zip(_offsets(yd), yd, _lags_from_left(yd, p)):
        u = y - _col(params[:, 0], y)
        for i, lag in enumerate(lags, start=1):
            # lags reaching into the dead prefix read the zeros the grid
            # keeps there: the zero-padded lags of the unsharded recursion
            u = u - _col(params[:, i], y) * lag
        live = _gpos(t0, y) >= d_dead + p
        es_u.append(u)
        lives.append(live)
    if q == 0:
        e = [torch.where(live, u, 0.0) for u, live in zip(es_u, lives)]
    elif q == 1:
        ms = [torch.where(live, -_col(params[:, 1 + p], u).expand_as(u), 0.0)
              for u, live in zip(es_u, lives)]
        bs = [torch.where(live, u, 0.0) for u, live in zip(es_u, lives)]
        e = _affine_scan_sharded(ms, bs)
    else:
        As, bs = [], []
        shift = torch.diag(yd[0].new_ones(q - 1), -1)[1:]
        for u, live in zip(es_u, lives):
            k, tl = u.shape
            theta = params[:, 1 + p:1 + p + q].to(u.device)
            # companion element: row 0 applies -theta, rows 1..q-1 shift
            row0 = (-theta)[:, None, None, :].expand(k, tl, 1, q)
            rows = shift.to(u.device)[None, None].expand(k, tl, q - 1, q)
            As.append(torch.where(live[..., None, None],
                                  torch.cat([row0, rows], dim=2), 0.0))
            bs.append(torch.cat([torch.where(live, u, 0.0)[..., None],
                                 u.new_zeros(k, tl, q - 1)], dim=-1))
        e = [x[..., 0] for x in _affine_scan_sharded_vec(As, bs)]
    css = _psum([(x * x).sum(1) for x in e])
    n = sum(y.shape[1] for y in yd)
    n_eff = (n - d_dead) - p
    sigma2 = css / n_eff
    return 0.5 * n_eff * (torch.log(2.0 * math.pi * sigma2) + 1.0)


def _sp_wols(cols, y2: Block, w: Block, ridge: float = 1e-8):
    """Weighted OLS across a time-sharded axis: the normal equations of
    ``models.arima._wols_cols`` with every Gram entry a sum of masked
    per-shard inner products, then the shared ridge-stabilized solve.
    ``cols``: columns, each a list of shards."""
    from ..utils.linalg import ridge_solve

    def dot(a, b):
        return _psum([(wj * aj * bj).sum(1) for wj, aj, bj in zip(w, a, b)])

    XtX = torch.stack([torch.stack([dot(ci, cj) for cj in cols], -1)
                       for ci in cols], -2)  # [keys_local, k, k]
    Xty = torch.stack([dot(ci, y2) for ci in cols], -1)
    return ridge_solve(XtX, Xty, ridge)


def sp_hannan_rissanen(ydb: Block, d_dead: int, p: int, q: int,
                       n: int) -> torch.Tensor:
    """Distributed Hannan-Rissanen startup values ``[keys_local, 1+p+q]``
    (intercept first) on a time-sharded differenced panel: the two-stage
    HR of ``models.arima.hannan_rissanen_batched`` (long-AR(m) OLS, its
    residuals as the innovations, one more OLS on ``[1, y-lags, e-lags]``),
    every normal-equation moment a sum over shards, the lag columns halos.
    ``n`` is the global length."""
    n_trim = n - d_dead
    m = min(p + q + 1, max(n_trim // 4, 1))
    offs = _offsets(ydb)
    by_shard = _lags_from_left(ydb, max(m, p))
    ylag = [[lags[i] for lags in by_shard] for i in range(max(m, p))]
    ones = [torch.ones_like(y) for y in ydb]

    # stage 1: AR(m) of yd on [1, lags 1..m] -> innovation estimates
    w1 = [(_gpos(t0, y) >= d_dead + m).to(y.dtype) for t0, y in
          zip(offs, ydb)]
    cols1 = [ones] + ylag[:m]
    beta1 = _sp_wols(cols1, ydb, w1)
    ehat = []
    for j, (y, w) in enumerate(zip(ydb, w1)):
        bj = beta1.to(y.device)
        pred = sum(bj[:, i, None] * c[j] for i, c in enumerate(cols1))
        ehat.append((y - pred) * w)

    # stage 2: OLS of yd on [1, y-lags 1..p, e-lags 1..q]
    e_by_shard = _lags_from_left(ehat, q)
    elag = [[lags[i] for lags in e_by_shard] for i in range(q)]
    cols2 = [ones] + ylag[:p] + elag
    w2 = [(_gpos(t0, y) >= d_dead + m + q).to(y.dtype) for t0, y in
          zip(offs, ydb)]
    return _sp_wols(cols2, ydb, w2)


def _carry_fold_across_shards(exits, reverse: bool):
    """Combine per-shard "latest valid (value, index, found)" summaries
    ``[(v, i, f), ...]`` (``[keys]`` each) into the carry ENTERING each
    shard: a fold over the shards, rightmost-valid-wins, or
    leftmost-valid-wins when walking ``reverse`` for the next-valid
    side.  The walk's first shard enters with nothing found."""
    order = range(len(exits) - 1, -1, -1) if reverse else range(len(exits))
    entering = [None] * len(exits)
    carry = None
    for j in order:
        xv, xi, xf = exits[j]
        if carry is None:
            entering[j] = (torch.zeros_like(xv), torch.zeros_like(xi),
                           torch.zeros_like(xf))
            carry = (xv, xi, xf)
            continue
        cv, ci, cf = (c.to(xv.device) for c in carry)
        entering[j] = (cv, ci, cf)
        carry = (torch.where(xf, xv, cv), torch.where(xf, xi, ci), xf | cf)
    return entering


def sp_fill_linear(block: Block) -> Block:
    """Linear-interpolation fill of time-sharded series (matches
    ``univariate.fill_linear`` on unsharded data: interior gaps are
    interpolated between the GLOBAL bracketing valid points, which may
    live on other shards, and edge NaNs survive).

    Per shard the previous / next valid position comes from a running
    max / min of valid positions (global int64 indices: float32 cannot
    hold positions past 2^24); each shard's exit summary is folded into
    the carry entering the others, the prefix-combine of
    :func:`sp_cumsum` for the "nearest valid observation" semigroup.
    """
    loc = []
    for t0, b in zip(_offsets(block), block):
        tl = b.shape[1]
        valid = ~torch.isnan(b)
        ar = torch.arange(tl, device=b.device)
        vals = torch.where(valid, torch.nan_to_num(b), 0.0)
        prev = torch.cummax(torch.where(valid, ar, -1), dim=1).values
        nxt = torch.flip(torch.cummin(torch.flip(
            torch.where(valid, ar, tl), [1]), dim=1).values, [1])
        pv = torch.gather(vals, 1, prev.clamp(min=0))
        nv = torch.gather(vals, 1, nxt.clamp(max=tl - 1))
        loc.append((t0, b, valid, pv, t0 + prev, prev >= 0,
                    nv, t0 + nxt, nxt < tl))
    e_prev = _carry_fold_across_shards(
        [(pv[:, -1], pi[:, -1], pf[:, -1])
         for _, _, _, pv, pi, pf, _, _, _ in loc], False)
    e_next = _carry_fold_across_shards(
        [(nv[:, 0], ni[:, 0], nf[:, 0])
         for _, _, _, _, _, _, nv, ni, nf in loc], True)
    out = []
    for (t0, b, valid, pv, pi, pf, nv, ni, nf), (epv, epi, epf), \
            (env, eni, enf) in zip(loc, e_prev, e_next):
        pv = torch.where(pf, pv, epv[:, None])
        pi = torch.where(pf, pi, epi[:, None])
        pf = pf | epf[:, None]
        nv = torch.where(nf, nv, env[:, None])
        ni = torch.where(nf, ni, eni[:, None])
        nf = nf | enf[:, None]
        interior = pf & nf
        span = torch.clamp(ni - pi, min=1).to(b.dtype)
        w = (_gpos(t0, b) - pi).to(b.dtype) / span
        interp = pv * (1.0 - w) + nv * w
        out.append(torch.where(valid, b,
                               torch.where(interior, interp, torch.nan)))
    return out


def sp_fill_linear_chain(block: Block):
    """Time-sharded fillLinear -> (filled, lag-1 difference, lag-1 shift):
    the distributed form of ``univariate.batch_fill_linear_chain`` (the lag
    crosses shard boundaries through a 1-column halo)."""
    f = sp_fill_linear(block)
    lagged = [torch.where(_gpos(t0, x) < 1, torch.nan, s) for t0, x, s in
              zip(_offsets(f), f, _shift1_from_left(f))]
    return f, [a - b for a, b in zip(f, lagged)], lagged


# ---------------------------------------------------------------------------
# Mesh-bound wrappers
# ---------------------------------------------------------------------------


def _split(a, spec, i: int, n_rows: int, cells) -> object:
    """Row group ``i``'s share of argument ``a`` under ``spec``: a list of
    per-cell time shards (time split), else the row block on the group's
    first cell (a replicated argument as a whole)."""
    if len(spec) == 0:
        return a.to(cells[0])
    rows = a[i * n_rows:(i + 1) * n_rows]
    if len(spec) > 1 and spec[1] == TIME_AXIS:
        tl = rows.shape[1] // len(cells)
        return [rows[:, j * tl:(j + 1) * tl].to(d) for j, d in
                enumerate(cells)]
    return rows.to(cells[0])


def _join(parts, spec, device) -> torch.Tensor:
    if isinstance(spec, dict):
        return {k: _join([p[k] for p in parts], s, device)
                for k, s in spec.items()}
    if not isinstance(spec, P):  # a tuple of output specs
        return tuple(_join([p[k] for p in parts], s, device)
                     for k, s in enumerate(spec))
    if len(spec) > 1 and spec[1] == TIME_AXIS:
        parts = [torch.cat([s.to(device) for s in p], dim=1) for p in parts]
    return torch.cat([p.to(device) for p in parts], dim=0)


def cell_map(fn, *, mesh: Mesh, in_specs, out_specs):
    """The port's ``shard_map``: ``fn`` runs once per series row group of
    ``mesh`` on that group's share of each argument.  An argument whose
    spec splits time (``P(SERIES_AXIS, TIME_AXIS)``) arrives as the list of
    its time shards, one per cell and on the cell's device; one split only
    over series (``P(SERIES_AXIS)`` / ``P(SERIES_AXIS, None)``) as the row
    block on the group's first cell; ``P()`` whole.  Outputs (a tensor, a
    tuple or a dict of them, by ``out_specs``) are joined on the mesh's
    first device.  The keys axis must divide by the series size and the
    time axis by the time size."""
    grid = mesh.devices if mesh.devices.ndim == 2 else mesh.devices[:, None]
    n_groups, n_cells = grid.shape

    def run(*args):
        for a, spec in zip(args, in_specs):
            if len(spec) and a.shape[0] % n_groups:
                raise ValueError(f"{a.shape[0]} rows do not split over "
                                 f"{n_groups} series shards")
            if (len(spec) > 1 and spec[1] == TIME_AXIS
                    and a.shape[1] % n_cells):
                raise ValueError(f"time axis of length {a.shape[1]} does "
                                 f"not divide across {n_cells} time shards")
        parts = []
        for i in range(n_groups):
            cells = list(grid[i])
            parts.append(fn(*(_split(a, spec, i, a.shape[0] // n_groups,
                                     cells)
                              for a, spec in zip(args, in_specs))))
        return _join(parts, out_specs, grid.flat[0])

    return run


_ST = P(SERIES_AXIS, TIME_AXIS)
_S = P(SERIES_AXIS)


def _bind(mesh: Mesh, fn, out_specs):
    return cell_map(fn, mesh=mesh, in_specs=(_ST,), out_specs=out_specs)


def sp_autocorr_sharded(mesh: Mesh, values: torch.Tensor,
                        max_lag: int) -> torch.Tensor:
    """``[keys, time]`` (time-sharded on a 2-D mesh) -> ``[keys,
    max_lag]``."""
    return _bind(mesh, functools.partial(sp_autocorr, max_lag=max_lag),
                 P(SERIES_AXIS, None))(values)


def sp_moments_sharded(mesh: Mesh,
                       values: torch.Tensor) -> Dict[str, torch.Tensor]:
    return _bind(mesh, sp_moments,
                 {k: _S for k in ("count", "mean", "var")})(values)


def sp_cumsum_sharded(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    return _bind(mesh, sp_cumsum, _ST)(values)


def sp_differences_sharded(mesh: Mesh, values: torch.Tensor,
                           k_lag: int = 1) -> torch.Tensor:
    return _bind(mesh, functools.partial(sp_differences, k_lag=k_lag),
                 _ST)(values)


def sp_fill_linear_sharded(mesh: Mesh, values: torch.Tensor) -> torch.Tensor:
    return _bind(mesh, sp_fill_linear, _ST)(values)


def sp_fill_linear_chain_sharded(mesh: Mesh, values: torch.Tensor):
    return _bind(mesh, sp_fill_linear_chain, (_ST,) * 3)(values)


def sp_ewma_smooth_sharded(mesh: Mesh, values: torch.Tensor,
                           alpha: torch.Tensor) -> torch.Tensor:
    """EWMA smoothing of a ``[keys, time]`` panel time-sharded on a 2-D
    mesh; ``alpha``: ``[keys]``."""
    return cell_map(sp_ewma_smooth, mesh=mesh, in_specs=(_ST, _S),
                    out_specs=_ST)(values, alpha)


# ---------------------------------------------------------------------------
# Time-sharded model FITS: the fit objective itself runs on the 2-D mesh.
#
# Family boundary: EWMA, ARMA CSS, GARCH and ARGARCH have affine carries
# that compose in O(1) (O(q^3) for the MA companion) state per element;
# Holt-Winters' carry (level, trend, seasonal ring) would cost O(m^2) per
# scan element, so its long-series fits stay series-sharded by design.
# ---------------------------------------------------------------------------


def _too_short_program(k: int):
    """NaN / not-converged ``FitResult`` with ``params [keys, k]`` for
    panels too short to identify a model: the gates depend only on the
    panel's length, so the too-short case never runs the optimizer."""
    from ..models.base import FitResult

    def too_short(vals):
        b = vals.shape[0]
        return FitResult(
            vals.new_full((b, k), torch.nan),
            vals.new_full((b,), torch.nan),
            torch.zeros(b, dtype=torch.bool, device=vals.device),
            torch.zeros(b, dtype=torch.int32, device=vals.device),
        )

    return too_short


def _sp_ewma_fit_program(mesh: Mesh, n: int, max_iters: int, tol: float):
    """The distributed EWMA fit for one (mesh, length, budget)."""
    from ..models.base import FitResult
    from ..utils import optim

    sse_sh = cell_map(sp_ewma_sse, mesh=mesh, in_specs=(_ST, _S),
                      out_specs=_S)
    n_eff = float(max(n - 1, 1))

    def run(vals):
        def fb(u):
            alpha = optim.sigmoid_to_interval(u[:, 0], 0.0, 1.0)
            return sse_sh(vals, alpha) / n_eff

        u0 = vals.new_zeros(vals.shape[0], 1)
        res = optim.minimize_lbfgs_batched(fb, u0, max_iters=max_iters,
                                           tol=tol)
        alpha = optim.sigmoid_to_interval(res.x, 0.0, 1.0)
        return FitResult(alpha, res.f * n_eff, res.converged, res.iters)

    return run


def _fit_dtype_tol(values, tol, f64: float, f32: float = 1e-4) -> float:
    if tol is None:  # the model module's dtype-dependent default
        tol = f64 if values.dtype == torch.float64 else f32
    return float(tol)


def sp_ewma_fit(mesh: Mesh, values: torch.Tensor, *, max_iters: int = 40,
                tol: float | None = None):
    """Fit EWMA ``alpha`` per series on a time-sharded dense panel.

    Matches ``models.ewma.fit`` (dense case) to optimizer tolerance: the
    same sigmoid-transformed mean-SSE objective and batched L-BFGS, every
    objective evaluation a :func:`cell_map` over the mesh.  Returns a
    ``FitResult`` with ``params [keys, 1]``.
    """
    tol = _fit_dtype_tol(values, tol, 1e-8)
    with _sp_fit_span("ewma", values), torch.no_grad():
        return _sp_ewma_fit_program(mesh, values.shape[1], max_iters,
                                    tol)(values)


def _sp_garch_fit_program(mesh: Mesh, n: int, max_iters: int, tol: float):
    """The distributed GARCH fit for one configuration."""
    from ..models import garch as _garch
    from ..models.base import FitResult
    from ..utils import optim

    if n < 10:
        # the identifiability gate of models.garch.fit (nv >= 10)
        return _too_short_program(3)

    def var_local(rb):
        # population variance (the dense-case seed, models.garch.variances)
        mean = _psum([x.sum(1) for x in rb]) / n
        return _psum([((x - _col(mean, x)) ** 2).sum(1) for x in rb]) / n

    var_sh = cell_map(var_local, mesh=mesh, in_specs=(_ST,), out_specs=_S)
    nll_sh = cell_map(sp_garch_neg_loglik, mesh=mesh,
                      in_specs=(P(SERIES_AXIS, None), _ST, _S),
                      out_specs=_S)

    def run(vals):
        var0 = var_sh(vals)
        nat0 = torch.stack([0.1 * torch.clamp(var0, min=1e-10),
                            torch.full_like(var0, 0.1),
                            torch.full_like(var0, 0.8)], dim=1)
        u0 = _garch._from_natural(nat0)

        def fb(u):
            return nll_sh(_garch._to_natural(u), vals, var0) / n

        res = optim.minimize_lbfgs_batched(fb, u0, max_iters=max_iters,
                                           tol=tol)
        return FitResult(_garch._to_natural(res.x), res.f * n,
                         res.converged, res.iters)

    return run


def sp_garch_fit(mesh: Mesh, values: torch.Tensor, *, max_iters: int = 80,
                 tol: float | None = None):
    """Fit GARCH(1,1) per series on a time-sharded dense returns panel ->
    ``FitResult`` with natural ``params [keys, 3]`` (omega, alpha, beta):
    the transform-parameterized mean-NLL objective and batched L-BFGS of
    ``models.garch.fit`` (dense case), through
    :func:`sp_garch_neg_loglik`."""
    tol = _fit_dtype_tol(values, tol, 1e-7)
    with _sp_fit_span("garch", values), torch.no_grad():
        return _sp_garch_fit_program(mesh, values.shape[1], max_iters,
                                     tol)(values)


def _sp_argarch_fit_program(mesh: Mesh, n: int, max_iters: int, tol: float):
    """The distributed ARGARCH fit for one configuration."""
    from ..models import garch as _garch
    from ..models.base import FitResult
    from ..utils import optim

    if n < 12:
        # AR(1) + GARCH needs a few more rows than GARCH alone
        return _too_short_program(5)

    def init_local(yb):
        # AR(1) moments (models.garch's ARGARCH start, dense case)
        mean = _psum([y.sum(1) for y in yb]) / n
        yc = [y - _col(mean, y) for y in yb]
        num = _psum([(a * b).sum(1) for a, b in
                     zip(yc, _shift1_from_left(yc))])
        den = _psum([(a * a).sum(1) for a in yc])
        phi0 = torch.clamp(num / torch.clamp(den, min=1e-12), -0.95, 0.95)
        c0 = mean * (1.0 - phi0)
        parts = []
        for t0, y, prev in zip(_offsets(yb), yb, _shift1_from_left(yb)):
            r = torch.where(_gpos(t0, y) < 1, 0.0,
                            y - _col(c0, y) - _col(phi0, y) * prev)
            parts.append((r * r).sum(1))
        rvar = _psum(parts) / n
        return torch.stack([c0, phi0, 0.1 * torch.clamp(rvar, min=1e-8),
                            torch.full_like(c0, 0.1),
                            torch.full_like(c0, 0.8)], dim=1)

    def nll_local(nat, yb, prev):
        # ``prev`` (the 1-column lag halo) is loop-invariant: the caller
        # forms it once, outside the optimizer
        rs, lives = [], []
        for t0, y, pv in zip(_offsets(yb), yb, prev):
            gp = _gpos(t0, y)
            lives.append((gp >= 1).to(y.dtype))
            rs.append(torch.where(gp < 1, 0.0, y - _col(nat[:, 0], y)
                                  - _col(nat[:, 1], y) * pv))
        # masked population variance of the residuals over t >= 1: the
        # GARCH seed follows the CURRENT (c, phi) at every evaluation
        nv = n - 1
        mean = _psum([(r * lv).sum(1) for r, lv in zip(rs, lives)]) / nv
        h0 = _psum([(lv * (r - _col(mean, r)) ** 2).sum(1)
                    for r, lv in zip(rs, lives)]) / nv
        return sp_garch_neg_loglik(nat[:, 2:], rs, h0, start=1)

    init_sh = cell_map(init_local, mesh=mesh, in_specs=(_ST,), out_specs=_S)
    prev_sh = cell_map(_shift1_from_left, mesh=mesh, in_specs=(_ST,),
                       out_specs=_ST)
    nll_sh = cell_map(nll_local, mesh=mesh,
                      in_specs=(P(SERIES_AXIS, None), _ST, _ST),
                      out_specs=_S)
    n_eff = float(max(n - 1, 1))

    def run(vals):
        u0 = _garch._argarch_from_natural(init_sh(vals))
        prev = prev_sh(vals)

        def fb(u):
            return nll_sh(_garch._argarch_to_natural(u), vals, prev) / n_eff

        res = optim.minimize_lbfgs_batched(fb, u0, max_iters=max_iters,
                                           tol=tol)
        return FitResult(_garch._argarch_to_natural(res.x), res.f * n_eff,
                         res.converged, res.iters)

    return run


def sp_argarch_fit(mesh: Mesh, values: torch.Tensor, *, max_iters: int = 100,
                   tol: float | None = None):
    """Fit AR(1)+GARCH(1,1) per series on a time-sharded dense panel ->
    ``FitResult`` with natural ``params [keys, 5]`` ``[c, phi, omega,
    alpha, beta]``: the objective and L-BFGS of ``models.garch.
    fit_argarch`` (dense case); the AR(1) mean removal is a 1-column halo,
    the GARCH seed a masked variance of the current residuals, the
    variance recursion :func:`sp_garch_neg_loglik` from ``start=1``."""
    tol = _fit_dtype_tol(values, tol, 1e-7)
    with _sp_fit_span("argarch", values), torch.no_grad():
        return _sp_argarch_fit_program(mesh, values.shape[1], max_iters,
                                       tol)(values)


def _sp_arima_fit_program(mesh: Mesh, n: int, order: tuple, max_iters: int,
                          tol: float):
    """The distributed ARIMA fit for one configuration."""
    from ..models.base import FitResult
    from ..utils import optim

    p, d, q = order
    k = 1 + p + q
    nvd = n - d
    # the identifiability gate of models.arima.fit (self-initialized
    # branch): lags + dof for the CSS fit, plus enough span that HR's
    # long-AR order m equals p+q+1
    if nvd < max(p + q + max(p + q + 1, 1) + k + 2, 4 * (p + q + 1)):
        return _too_short_program(k)

    # a halo delivers at most ONE neighbour's columns, so every lag reach
    # (AR lags, HR's long-AR order m, HR's e-lags) must fit in one shard
    tl = n // mesh.shape.get(TIME_AXIS, 1)
    m = min(p + q + 1, max(nvd // 4, 1))
    if max(m, p, q) > tl:
        raise ValueError(
            f"time-shard length {tl} is shorter than the longest lag reach "
            f"{max(m, p, q)} for order {order}; use fewer time shards or a "
            "longer panel"
        )

    def diff_dead(v):
        # order-d differencing on the original grid: position t holds
        # yd_t = sum_j (-1)^j C(d,j) y_{t-j}; the first d positions are dead
        for _ in range(d):
            v = [a - b for a, b in zip(v, _shift1_from_left(v))]
        return [torch.where(_gpos(t0, x) >= d, x, 0.0)
                for t0, x in zip(_offsets(v), v)]

    diff_sh = cell_map(diff_dead, mesh=mesh, in_specs=(_ST,), out_specs=_ST)
    init_sh = cell_map(
        functools.partial(sp_hannan_rissanen, d_dead=d, p=p, q=q, n=n),
        mesh=mesh, in_specs=(_ST,), out_specs=P(SERIES_AXIS, None))
    nll_sh = cell_map(
        functools.partial(sp_css_neg_loglik, d_dead=d, p=p, q=q), mesh=mesh,
        in_specs=(P(SERIES_AXIS, None), _ST), out_specs=_S)
    n_eff = float(max(nvd - p, 1))

    def run(vals):
        yd = diff_sh(vals)

        def fb(params):
            return nll_sh(params, yd) / n_eff

        res = optim.minimize_lbfgs_batched(fb, init_sh(yd),
                                           max_iters=max_iters, tol=tol)
        return FitResult(res.x, res.f * n_eff, res.converged, res.iters)

    return run


def sp_arima_fit(mesh: Mesh, values: torch.Tensor, order: Order = (1, 1, 1),
                 *, max_iters: int = 60, tol: float | None = None):
    """Fit ARIMA(p, d, q) with intercept per series on a time-sharded dense
    panel -> ``FitResult`` with ``params [keys, 1+p+q]`` rows ``[c,
    phi_1..p, theta_1..q]``.

    Order-d differencing (halos, the dead prefix kept on the grid), the
    two-stage Hannan-Rissanen start from normal equations summed over
    shards (:func:`sp_hannan_rissanen`), then batched L-BFGS on
    :func:`sp_css_neg_loglik`, whose MA recursion is the doubling affine
    scan (companion-matrix for q > 1).  Matches ``models.arima.fit`` to
    optimizer tolerance (both minimize the same CSS objective).  Panels too
    short for the order come back NaN / not-converged without running the
    optimizer (the unsharded fit's gate); a lag reach wider than a time
    shard raises ``ValueError``.
    """
    tol = _fit_dtype_tol(values, tol, 1e-6)
    with _sp_fit_span("arima", values), torch.no_grad():
        return _sp_arima_fit_program(mesh, values.shape[1], tuple(order),
                                     max_iters, tol)(values)

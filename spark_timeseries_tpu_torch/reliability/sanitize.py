"""Input sanitization pass: repair or reject rows a batched fit cannot
survive (port of ``reliability/sanitize.py``).

A batched fit runs every row in one call, so bad input must be found and
neutralized BEFORE the fit.  Models already tolerate leading/trailing NaNs
(the ragged-panel contract, ``models.base.align_right``); what they cannot
tolerate is

- ``inf``/``-inf`` anywhere (squares overflow, gradients go non-finite),
- NaN *inside* the valid span (``align_right`` zero-fills them, silently
  biasing the fit),
- constant rows (zero innovation variance -> ``log(0)`` objectives), and
- all-NaN rows (nothing to fit).

:func:`sanitize` detects all four with a few reductions over the panel on
its own device (in row blocks, so the temporaries stay small beside a
full-width panel) and applies a configurable policy, emitting a per-row
:class:`~.status.FitStatus` code.  Only the rows to repair are gathered and
filled (``ops.univariate.fill_linear``); rows it does not touch are
returned BIT-IDENTICAL, so healthy rows fit exactly as they would have
without the pass.  A panel with nothing to repair or exclude comes back as
the same tensor, not a copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import obs
from .status import STATUS_DTYPE, FitStatus

POLICIES = ("impute", "exclude", "raise")

# elements a probe block reads: bounds the probe's temporaries (a few
# bool / uint8 / float copies of one block) at ~1 GiB on a wide panel
_PROBE_BLOCK_ELEMENTS = 1 << 26


class SanitizeReport(NamedTuple):
    """Output of :func:`sanitize`."""

    values: torch.Tensor  # [B, T] cleaned panel (untouched rows bit-identical)
    status: np.ndarray  # [B] int8: OK / SANITIZED / EXCLUDED
    flags: dict  # per-row bool masks: had_inf / interior_nan / constant / all_nan
    meta: dict  # summary counts for result metadata


def _probe_block(yb: torch.Tensor) -> torch.Tensor:
    """Per-row fault masks of one row block, ``[4, rows]`` bool: had_inf,
    interior_nan, constant, all_nan — the reference's definitions (an
    all-NaN row counts as interior NaN too, as there)."""
    t = yb.shape[1]
    valid = torch.isfinite(yb)  # == ~isnan(y with inf -> NaN)
    had_inf = torch.isinf(yb).any(1)
    v8 = valid.view(torch.uint8)  # the same bytes, no copy
    n_valid = v8.sum(1)
    any_valid = n_valid > 0
    # first valid position: argmax returns the first maximal index; last:
    # the largest 1-based index of a valid entry (0 on an all-NaN row)
    first = v8.argmax(1)
    pos = torch.arange(1, t + 1, device=yb.device,
                       dtype=torch.int16 if t < 2**15 else torch.int32)
    last = torch.where(valid, pos, 0).amax(1).long() - 1
    interior_nan = ((last - first + 1) > n_valid) | ~any_valid
    # min and max of the valid entries in one pass: the invalid entries
    # take the row's first valid value, which is one of them
    ref = yb.gather(1, first[:, None])
    lo, hi = torch.aminmax(torch.where(valid, yb, ref), dim=1)
    constant = any_valid & (hi == lo)
    return torch.stack([had_inf, interior_nan, constant, ~any_valid])


def _probe(yb: torch.Tensor) -> np.ndarray:
    """``[4, B]`` host bool masks (one read of the whole batch)."""
    step = max(1, _PROBE_BLOCK_ELEMENTS // max(yb.shape[1], 1))
    masks = torch.cat([_probe_block(yb[lo:lo + step])
                       for lo in range(0, yb.shape[0], step)], dim=1)
    return masks.cpu().numpy()


def _impute(yb: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """The given rows with inf -> NaN and interior gaps linearly filled
    (edges stay NaN), gathered: ``[len(rows), T]``."""
    from ..ops import univariate as uv  # models.base imports this package

    sub = yb[torch.as_tensor(rows, device=yb.device)]
    sub = sub.masked_fill(torch.isinf(sub), float("nan"))
    return uv.fill_linear(sub)


def sanitize(y, policy: str = "impute") -> SanitizeReport:
    """Detect and handle non-finite / degenerate rows of a ``[B, T]`` panel.

    ``y`` is a tensor (kept on its device) or an array-like (moved to the
    card).  ``policy`` governs rows with repairable faults (inf entries or
    NaNs inside the valid span):

    - ``"impute"``: inf -> NaN, interior NaNs linearly interpolated
      (``ops.univariate.fill_linear``); the row is flagged ``SANITIZED``.
    - ``"exclude"``: the row is replaced by all-NaN (models return NaN
      params for it without touching its neighbors) and flagged
      ``EXCLUDED``.
    - ``"raise"``: a ``ValueError`` naming the offending rows.

    Constant and all-NaN rows are unrepairable (no innovation variance /
    nothing to fit): they are excluded under both non-raising policies.
    Leading/trailing NaNs alone are NOT faults — ragged panels pass
    through untouched (the ``align_right`` contract).
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown sanitize policy {policy!r} (one of {POLICIES})")
    if not isinstance(y, torch.Tensor):
        from ..models.base import to_device  # it imports this package

        y = to_device(y)
    if y.ndim != 2:
        raise ValueError(f"sanitize expects [batch, time], got "
                         f"{tuple(y.shape)}")
    with obs.span("sanitize", rows=int(y.shape[0]), policy=policy):
        return _sanitize_timed(y, policy)


def _sanitize_timed(yb: torch.Tensor, policy: str) -> SanitizeReport:
    had_inf, interior_nan, constant, all_nan = _probe(yb)

    repairable = had_inf | interior_nan
    unusable = constant | all_nan
    if policy == "raise" and (repairable | unusable).any():
        bad = np.nonzero(repairable | unusable)[0]
        raise ValueError(
            f"{bad.size} rows failed sanitization (policy='raise'), e.g. rows "
            f"{bad[:5].tolist()}: inf={int(had_inf.sum())}, "
            f"interior NaN={int(interior_nan.sum())}, "
            f"constant={int(constant.sum())}, all-NaN={int(all_nan.sum())}"
        )

    status = np.zeros(yb.shape[0], STATUS_DTYPE)
    if policy == "impute":
        excluded = unusable
        status[repairable & ~excluded] = FitStatus.SANITIZED
    else:  # exclude
        excluded = unusable | repairable
    status[excluded] = FitStatus.EXCLUDED

    out = yb
    repair = np.nonzero(repairable & ~excluded)[0]
    drop = np.nonzero(excluded)[0]
    if repair.size or drop.size:
        out = yb.clone()
        if repair.size:
            out[torch.as_tensor(repair, device=yb.device)] = _impute(yb,
                                                                     repair)
        if drop.size:
            out[torch.as_tensor(drop, device=yb.device)] = float("nan")

    flags = {
        "had_inf": had_inf,
        "interior_nan": interior_nan,
        "constant": constant,
        "all_nan": all_nan,
    }
    meta = {
        "policy": policy,
        "rows_sanitized": int((status == FitStatus.SANITIZED).sum()),
        "rows_excluded": int((status == FitStatus.EXCLUDED).sum()),
        **{f"rows_{k}": int(v.sum()) for k, v in flags.items()},
    }
    # telemetry: sanitizer actions as monotonic counters (no-ops when off)
    obs.counter("sanitize.rows_checked").add(int(yb.shape[0]))
    obs.counter("sanitize.rows_sanitized").add(meta["rows_sanitized"])
    obs.counter("sanitize.rows_excluded").add(meta["rows_excluded"])
    for k, v in flags.items():
        n = int(v.sum())
        if n:
            obs.counter(f"sanitize.rows_{k}").add(n)
    return SanitizeReport(out, status, flags, meta)

"""Per-row fit status vocabulary shared by every fit path.

The PyTorch port's copy of ``spark_timeseries_tpu.reliability.status``: the
codes are journaled, so both packages must agree on every integer.  A fit
runs the whole panel as one batch, so "what happened" is a per-ROW record:
every public ``fit`` returns a ``status`` array of :class:`FitStatus` codes
alongside the parameters.

Codes are ordered by severity so ladder stages can be merged with an
elementwise ``maximum`` — a row keeps the most severe thing that happened
to it:

====  ==========  ====================================================
code  name        meaning
====  ==========  ====================================================
0     OK          fit converged on the primary path, params finite
1     SANITIZED   input was repaired (NaN/Inf imputed) before fitting
2     RETRIED     primary fit failed; a retry rung (perturbed init /
                  larger budget) succeeded
3     FALLBACK    retries failed; the conservative fallback rung
                  (portable backend, no compaction) succeeded
4     DIVERGED    every rung failed; params are NaN, row is flagged
                  instead of poisoning the batch
5     EXCLUDED    input rejected before/without fitting (all-NaN,
                  constant, too short, or policy="exclude" hit)
6     TIMEOUT     the chunk holding the row overran its wall-clock
                  budget (reliability.watchdog); the fit never
                  finished, params are NaN
====  ==========  ====================================================
"""

from __future__ import annotations

import enum

import numpy as np


class FitStatus(enum.IntEnum):
    """Severity-ordered per-row fit outcome (see module docstring)."""

    OK = 0
    SANITIZED = 1
    RETRIED = 2
    FALLBACK = 3
    DIVERGED = 4
    EXCLUDED = 5
    TIMEOUT = 6


# dtype every status array uses (device and host side)
STATUS_DTYPE = np.int8


def status_counts(status) -> dict:
    """``{status_name: row_count}`` for a status array (host-side)."""
    s = np.asarray(status)
    return {m.name: int((s == m.value).sum()) for m in FitStatus}


def merge_status(a, b):
    """Elementwise most-severe-wins merge of two status arrays."""
    return np.maximum(np.asarray(a), np.asarray(b)).astype(STATUS_DTYPE)

"""Resilient fit execution: the batch analog of Spark task retry (port of
``reliability/``).

A NaN-poisoned executor task was re-run elsewhere by Spark; here a fit is
one batched call over many rows, so this package rebuilds the same
guarantees at row granularity:

- :mod:`.status` — the per-row :class:`FitStatus` vocabulary every public
  ``fit`` reports.
- :mod:`.sanitize` — input repair/rejection (NaN/Inf/constant/all-NaN)
  with an impute / exclude / raise policy.
- :mod:`.runner` — :func:`resilient_fit`: sanitize, fit, then a retry ->
  fallback ladder over the failed subset (perturbed inits, the plain
  PyTorch backend) before any row is marked ``DIVERGED``.
- :mod:`.watchdog` — :func:`call_with_deadline` / :class:`Deadline`:
  wall-clock budgets for a fit call and for a whole job.
- :mod:`.plan` — the allocation-failure classifier
  :func:`is_resource_exhausted` (the rest of the execution plan comes
  with the journaled chunk walk).
- :mod:`.faultinject` — deterministic data faults and fit wrappers that
  drive every rung of the ladder in tests.

The journaled, pipelined chunk walk of the reference (``journal``,
``sink``, ``source``, ``committer``, ``prefetcher``, ``chunked``,
``delta``, ``chaos``) is not ported yet.
"""

from . import faultinject, plan, runner, sanitize, status, watchdog
from .plan import OOMBackoffExceeded, is_resource_exhausted
from .runner import (ResilientFitResult, RetryRung, default_ladder,
                     resilient_fit)
from .sanitize import SanitizeReport, sanitize
from .status import STATUS_DTYPE, FitStatus, merge_status, status_counts
from .watchdog import Deadline, DeadlineExceeded, call_with_deadline

__all__ = [
    "Deadline",
    "DeadlineExceeded",
    "FitStatus",
    "OOMBackoffExceeded",
    "ResilientFitResult",
    "RetryRung",
    "STATUS_DTYPE",
    "SanitizeReport",
    "call_with_deadline",
    "default_ladder",
    "faultinject",
    "is_resource_exhausted",
    "merge_status",
    "plan",
    "resilient_fit",
    "runner",
    "sanitize",
    "status",
    "status_counts",
    "watchdog",
]

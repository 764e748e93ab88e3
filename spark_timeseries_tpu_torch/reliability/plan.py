"""Execution plan of the chunk walk: the resource-exhaustion classifier
(port of the head of ``reliability/plan.py``).

Only the part of the reference module that the resilient fit path needs is
here: :class:`OOMBackoffExceeded`, the allocation-failure markers and
:func:`is_resource_exhausted`, which ``runner.resilient_fit`` uses to skip
crash dumps for errors a chunk driver above it recovers from.  The rest of
the reference module — ``ExecutionPlan``, ``LaneSpec``, ``LaneRunner``,
``LaneSupervisor``, ``WorkQueue``, ``RestagedPanel`` and ``shard_spans`` —
belongs to the journaled chunk walk and is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["OOMBackoffExceeded", "is_resource_exhausted"]

# substrings of allocation-failure messages: the reference runtime's
# RESOURCE_EXHAUSTED, and the CUDA caching allocator's "CUDA out of
# memory"; the simulated OOM of reliability.faultinject raises with the
# same marker so CPU tests drive this path without a real exhaustion
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")


class OOMBackoffExceeded(RuntimeError):
    """Raised when the minimum chunk size still exhausts device memory."""


def is_resource_exhausted(e: BaseException) -> bool:
    """True for allocation failures: ``torch.cuda.OutOfMemoryError``,
    ``MemoryError``, and RuntimeErrors whose message carries an
    out-of-memory marker (the simulated ``RESOURCE_EXHAUSTED``, or a CUDA
    allocation failure raised as a plain RuntimeError)."""
    if isinstance(e, MemoryError):
        return True
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return True
    if not isinstance(e, RuntimeError):
        return False
    msg = str(e)
    return any(m in msg for m in _OOM_MARKERS)

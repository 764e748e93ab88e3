"""Peak-memory probe: the CUDA caching allocator's peak, with a host-RSS
fallback (port of ``obs/memory.py``).

On the card the reading is the allocator's peak of allocated bytes
(``torch.cuda.memory_stats()["allocated_bytes.all.peak"]``) — the number
capacity planning wants — once CUDA has been initialized in this process.
Without CUDA (the CPU, or a process that never touched the card) the probe
degrades to the process's peak resident set via ``resource.getrusage``,
a labelled diagnostic: the ``source`` field says which probe produced the
number, so a dashboard cannot mistake host RSS for device memory.

The reference also keeps a registry of host staging pools
(``register_staging_pool``) for its host-resident chunk walk; it comes
with that walk, so ``staging_pool_bytes`` stays None here.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional

__all__ = ["PeakMemory", "peak_memory"]


class PeakMemory(NamedTuple):
    """A peak-memory reading and the probe that produced it."""

    bytes: Optional[int]  # None only when every probe failed
    source: str  # "device" | "host_rss" | "unavailable"
    # peak host bytes of the host-resident walk's staging pools: None
    # until that walk is ported (the reference's field, kept for its shape)
    staging_pool_bytes: Optional[int] = None


def _device_peak() -> Optional[int]:
    """The CUDA caching allocator's peak allocated bytes on the current
    device, or None when CUDA was never initialized in this process (the
    probe itself must not initialize it)."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return None
        stats = torch.cuda.memory_stats() or {}
        peak = (stats.get("allocated_bytes.all.peak")
                or torch.cuda.max_memory_allocated())
    except Exception:  # noqa: BLE001 - diagnostics only, never fail the fit
        return None
    return int(peak) if peak else None


def _host_peak_rss() -> Optional[int]:
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    except Exception:  # noqa: BLE001 - e.g. no resource module (Windows)
        return None
    if not peak:
        return None
    # ru_maxrss is KiB on Linux, bytes on macOS
    return int(peak) if sys.platform == "darwin" else int(peak) * 1024


def peak_memory() -> PeakMemory:
    """Best available peak-memory reading (see module docstring).

    With CUDA initialized the reading is the device allocator's peak; on
    the CPU it degrades to host peak RSS rather than ``None`` — the source
    field says which, and consumers must label accordingly.
    """
    b = _device_peak()
    if b is not None:
        return PeakMemory(b, "device")
    b = _host_peak_rss()
    if b is not None:
        return PeakMemory(b, "host_rss")
    return PeakMemory(None, "unavailable")

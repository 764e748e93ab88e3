"""Peak-memory probe: the CUDA caching allocator's peak, with a host-RSS
fallback (port of ``obs/memory.py``).

On the card the reading is the allocator's peak of allocated bytes
(``torch.cuda.memory_stats()["allocated_bytes.all.peak"]``) — the number
capacity planning wants — once CUDA has been initialized in this process.
Without CUDA (the CPU, or a process that never touched the card) the probe
degrades to the process's peak resident set via ``resource.getrusage``,
a labelled diagnostic: the ``source`` field says which probe produced the
number, so a dashboard cannot mistake host RSS for device memory.

Host-resident chunk walks stage their copies to the card through reusable
pinned staging buffers (``reliability.source.StagingPool``); those pools
:func:`register_staging_pool` themselves here, and the probe reports their
combined peak host footprint as ``staging_pool_bytes`` next to the device
or RSS reading — a host-resident run's manifest then carries both the
device peak AND the staging RAM that made it possible.
"""

from __future__ import annotations

import sys
import threading
import weakref
from typing import NamedTuple, Optional

__all__ = ["PeakMemory", "peak_memory", "register_staging_pool"]

# staging pools currently alive in this process (weak: a pool's lifetime
# belongs to its ChunkSource, never to the probe).  The lock covers both
# registration and iteration: the probe runs on committer worker threads
# while another thread may be constructing a source.
_staging_pools: "weakref.WeakSet" = weakref.WeakSet()
_staging_pools_mu = threading.Lock()


def register_staging_pool(pool) -> None:
    """Track a staging pool so :func:`peak_memory` reports its bytes.

    ``pool`` must expose ``peak_host_bytes`` (an int attribute); the
    registry holds it weakly.
    """
    with _staging_pools_mu:
        _staging_pools.add(pool)


def _staging_pool_peak() -> Optional[int]:
    with _staging_pools_mu:
        pools = list(_staging_pools)
    total = sum(int(p.peak_host_bytes) for p in pools)
    return total or None


class PeakMemory(NamedTuple):
    """A peak-memory reading and the probe that produced it."""

    bytes: Optional[int]  # None only when every probe failed
    source: str  # "device" | "host_rss" | "unavailable"
    # combined peak host bytes of registered staging pools (None when no
    # host-resident walk ran) — reported alongside, never folded into
    # ``bytes``: staging RAM is host memory regardless of ``source``
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
    sp = _staging_pool_peak()
    b = _device_peak()
    if b is not None:
        return PeakMemory(b, "device", sp)
    b = _host_peak_rss()
    if b is not None:
        return PeakMemory(b, "host_rss", sp)
    return PeakMemory(None, "unavailable", sp)

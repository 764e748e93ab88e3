"""Compiled-program accounting and the persistent build directory of the
CUDA kernel libraries (port of ``utils/compile_cache.py``).

The port's only compiled programs are the kernel libraries of
:mod:`..ops._build`: each ``csrc/<name>.cu`` (with its ``-D`` variant
macros) becomes one shared library, built by ``nvcc`` once and then
loaded.  This module is the one switch and the one ledger for them:

- :func:`enable_compile_cache` — point ``_build``'s build directory at a
  cache directory, so a restarted process (or another checkout) loads the
  libraries an earlier one built instead of re-running ``nvcc``.
  Libraries are keyed by a hash of their sources and flags, so a stale
  entry is never loaded: an edited source gets a new file name.
- ``STSTPU_COMPILE_CACHE=<dir>`` — environment opt-in honored by
  :func:`enable_from_env`.

Deliberately OPT-IN, as in the reference: without it the libraries land in
the package's own ``_build/`` directory.

This module also owns the PROGRAM-reuse counters (``compile_cache.hit`` /
``compile_cache.miss`` in the obs registry), one lookup per library a
process uses: ``_build.build_all`` reports a miss for each library it runs
``nvcc`` for, and ``_build.load`` a hit when it first finds a library
built on disk by an earlier run.  The reference counts a lookup per fit
call of a cached jitted program; a loaded library is reused by every
launch, which is not a lookup.  Process-local mirrors ride along so the counts are readable with the
obs plane off (the obs counters stay authoritative for per-run deltas).
"""

from __future__ import annotations

import os
import threading as _threading
from typing import Optional

__all__ = ["enable_compile_cache", "enable_from_env", "enabled_dir",
           "note_hit", "note_miss", "program_cache_stats"]

_ENV_VAR = "STSTPU_COMPILE_CACHE"
_enabled_dir: Optional[str] = None

_hits = 0
_misses = 0
# concurrent threads (watchdog workers, lanes) report through here; the
# obs counters carry their own locks, but these process-local mirrors
# would otherwise lose increments to the non-atomic load/add/store
_stats_lock = _threading.Lock()

# lock-discipline contract (module-level form): every thread that loads or
# builds a library reports hits/misses under the lock.
_PROTECTED_BY_ = {"_hits": "_stats_lock", "_misses": "_stats_lock"}


def note_hit() -> None:
    """Record a program-cache hit (a kernel library built on disk by an
    earlier run, loaded without ``nvcc``)."""
    global _hits
    with _stats_lock:
        _hits += 1
    from .. import obs

    obs.counter("compile_cache.hit").inc()


def note_miss() -> None:
    """Record a program-cache miss (a kernel library built by ``nvcc``)."""
    global _misses
    with _stats_lock:
        _misses += 1
    from .. import obs

    obs.counter("compile_cache.miss").inc()


def program_cache_stats() -> dict:
    """Process-lifetime program-cache accounting: ``{hits, misses,
    hit_rate}`` (hit_rate None before the first lookup)."""
    with _stats_lock:
        hits, misses = _hits, _misses
    total = hits + misses
    return {
        "hits": hits,
        "misses": misses,
        "hit_rate": round(hits / total, 4) if total else None,
    }


def enable_compile_cache(cache_dir: str) -> Optional[str]:
    """Build and load the kernel libraries under ``cache_dir``.

    Returns the directory in effect, or ``None`` when it cannot be created
    (never raises: a missing cache only costs rebuilds).  Libraries already
    loaded in this process stay loaded; the next library asked for is
    looked up, and built if absent, under ``cache_dir``.
    """
    global _enabled_dir
    try:
        from pathlib import Path

        from ..ops import _build

        cache_dir = os.path.abspath(cache_dir)
        os.makedirs(cache_dir, exist_ok=True)
        _build.BUILD_DIR = Path(cache_dir)
        _enabled_dir = cache_dir
        return cache_dir
    except OSError:  # read-only or unreachable directory
        return None


def enable_from_env() -> Optional[str]:
    """Honor ``STSTPU_COMPILE_CACHE=<dir>`` (no-op when unset)."""
    d = os.environ.get(_ENV_VAR)
    if not d:
        return None
    return enable_compile_cache(d)


def enabled_dir() -> Optional[str]:
    """The cache directory enabled through this module, if any."""
    return _enabled_dir

"""Durable per-tenant auto-fit profiles (port of ``serving/profiles.py``).

The warm half of serving: the fleet's shared checkpoint root is where
per-TENANT state becomes fleet-wide instead of per-process, and the
:class:`TenantProfileStore` is that state — one npz per tenant under
``<root>/profiles/`` recording the tenant's last winning orders, fitted
params, panel fingerprint, and a stability counter.  A repeat auto-fit
submit classifies against its profile:

- **stable** — the panel's prefix fingerprint, row count, and fit config
  all match: stage 1 is skipped entirely (a warm-started refit of each
  row's known winning order, ``reliability.delta.WarmstartFit``).
- **drifted** — same shape/config but the content moved: a stepwise
  search seeded from the profile's distinct winners.
- **new** — no profile, or the shape/config changed: the full stepwise
  search (or the exhaustive grid in exact mode).

Writes go through ``journal.durable_replace`` (tmp + fsync + replace —
whole file or previous content, never torn) and are lease-FENCED like
every primary write on a fleet root: the store's ``fence`` callable runs
before bytes land, so a zombie primary dies loudly in ``FencedError``
instead of clobbering the survivor's warm state.  Standbys (and tools)
read profiles without any lease — reads are just npz loads, cached per
``(mtime, size)`` so a takeover sees the dead primary's last durable
update by construction.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..reliability import journal as journal_mod

__all__ = ["TenantProfileStore", "config_key"]

# profile schema version: bump when the npz field layout changes so an
# old profile degrades to a "new" classification, never a misread
PROFILE_VERSION = 1

_ARRAY_FIELDS = ("params", "order_index", "criterion", "status", "orders")


def config_key(fit_kwargs: dict) -> str:
    """Digest of the fit configuration a profile's params were won under.

    Everything that changes the fit OUTPUT must count (criterion,
    intercept, iteration budget, backend, the candidate grid, ...) —
    routing knobs that only change HOW the search runs (``warm_routing``
    itself) are excluded by the caller.  Sorted-JSON over the kwargs, so
    the key is stable across submit spellings and the wire round-trip.
    """
    payload = json.dumps(fit_kwargs, sort_keys=True, default=repr)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def _safe_name(tenant: str) -> str:
    """Collision-safe filename for a tenant id: a sanitized prefix for
    humans plus a content digest for uniqueness."""
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(tenant))[:48]
    digest = hashlib.sha256(str(tenant).encode()).hexdigest()[:10]
    return f"{safe}-{digest}"


class TenantProfileStore:
    """Durable tenant profiles on a (possibly fleet-shared) root.

    .. attribute:: _protected_by_

        Lock-discipline contract (tools/lint lock-map): the read cache
        mutates only under its lock — the serve loop updates profiles
        while caller threads classify repeat submits, and tools/standby
        readers may share an instance.

    ``fence`` is the write-side fencing hook: when set (the fleet's
    primary sets it to ``Lease.check``), it runs before EVERY profile
    write and must raise to refuse the write — profile updates obey the
    same zombie-writer discipline as result stores and journal commits.
    Plain (non-fleet) servers leave it ``None``.

    ``max_age_s`` / ``max_profiles`` bound the store: profiles older
    than ``max_age_s`` since their last update, and the oldest profiles
    beyond ``max_profiles``, are evicted — a dormant tenant's warm state must not hold the shared
    root's disk forever.  Eviction runs after every fenced
    :meth:`update` and on demand via :meth:`evict`; deletes are fenced
    exactly like writes (a zombie primary must not reap the survivor's
    profiles).  ``clock`` is injectable for tests; wall-clock here is
    metadata-only and never feeds fitted bytes.
    """

    _protected_by_ = {"_cache": "_lock"}

    def __init__(self, root: str, *, fence: Optional[Callable] = None,
                 max_age_s: Optional[float] = None,
                 max_profiles: Optional[int] = None,
                 clock: Callable[[], float] = time.time):
        self.root = os.path.abspath(root)
        self.fence = fence
        self.max_age_s = (float(max_age_s) if max_age_s is not None
                          else None)
        self.max_profiles = (int(max_profiles) if max_profiles is not None
                             else None)
        self._clock = clock
        self._lock = threading.Lock()
        self._cache: Dict[str, tuple] = {}

    def path(self, tenant: str) -> str:
        return os.path.join(self.root, f"{_safe_name(tenant)}.npz")

    # -- reads (unfenced: standbys and tools read freely) --------------------

    def load(self, tenant: str) -> Optional[dict]:
        """The tenant's profile dict, or ``None`` (absent/torn/stale
        version).  Cached per ``(mtime_ns, size)``: a fresh write — ours
        or a peer primary's on the shared root — invalidates by
        construction."""
        path = self.path(tenant)
        try:
            st = os.stat(path)
        except OSError:
            return None
        key = (st.st_mtime_ns, st.st_size)
        with self._lock:
            ent = self._cache.get(tenant)
            if ent is not None and ent[0] == key:
                return ent[1]
        prof = self._read(path)
        with self._lock:
            self._cache[tenant] = (key, prof)
        return prof

    def _read(self, path: str) -> Optional[dict]:
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"].tobytes()).decode())
                prof = {f: np.array(z[f]) for f in _ARRAY_FIELDS}
        except Exception:  # noqa: BLE001 - torn/foreign bytes, not a bug
            return None
        if meta.get("version") != PROFILE_VERSION:
            return None
        prof.update(meta)
        return prof

    def tenants(self) -> list:
        """Sorted tenant ids with a readable profile on this root (the
        budget advisor's iteration surface)."""
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".npz") or fn.startswith(".tmp-"):
                continue
            prof = self._read(os.path.join(self.root, fn))
            if prof is not None:
                out.append(prof["tenant"])
        return sorted(out)

    # -- classification ------------------------------------------------------

    def classify(self, tenant: str, values: np.ndarray,
                 cfg_key: str) -> tuple:
        """``(route, profile)`` for a repeat submit: ``"stable"`` when the
        panel's first ``prefix_cols`` columns fingerprint-match the
        profile (an exact repeat AND an appended-ticks panel both
        qualify — the profile's params warm-start the longer panel),
        ``"drifted"`` when the shape/config match but the content moved,
        ``"new"`` otherwise."""
        prof = self.load(tenant)
        if prof is None:
            return "new", None
        values = np.asarray(values)
        if (prof.get("config_key") != cfg_key
                or int(prof.get("rows", -1)) != int(values.shape[0])
                or int(values.shape[1]) < int(prof.get("prefix_cols", 0))):
            return "new", prof
        pc = int(prof["prefix_cols"])
        fp = journal_mod.panel_fingerprint(values[:, :pc])
        if fp == prof.get("fingerprint"):
            return "stable", prof
        return "drifted", prof

    # -- writes (fenced, durable) --------------------------------------------

    def update(self, tenant: str, *, values: np.ndarray, orders,
               order_index, params, criterion, status, cfg_key: str,
               criterion_name: str, include_intercept: bool,
               route: str) -> dict:
        """Record one completed auto-fit pass for ``tenant`` — fenced,
        then durable via ``journal.durable_replace``.

        The stability counter compares each row's winning ORDER (not its
        grid index — stepwise grids grow between passes) against the
        previous profile: an unchanged winner map increments it, any
        movement resets it to 0.  Returns the profile as written.
        """
        values = np.asarray(values)
        order_index = np.asarray(order_index, np.int32)
        orders = np.asarray(orders, np.int32).reshape(-1, 3)
        prev = self.load(tenant)
        stability = 0
        if prev is not None and prev.get("config_key") == cfg_key and \
                int(prev["rows"]) == int(values.shape[0]):
            if np.array_equal(_winner_orders(prev["orders"],
                                             prev["order_index"]),
                              _winner_orders(orders, order_index)):
                stability = int(prev.get("stability", 0)) + 1
        meta = {
            "version": PROFILE_VERSION,
            "updated_at": float(self._clock()),
            "tenant": str(tenant),
            "fingerprint": journal_mod.panel_fingerprint(values),
            "prefix_cols": int(values.shape[1]),
            "n_time": int(values.shape[1]),
            "rows": int(values.shape[0]),
            "stability": stability,
            "passes": (int(prev.get("passes", 0)) + 1
                       if prev is not None else 1),
            "config_key": str(cfg_key),
            "criterion_name": str(criterion_name),
            "include_intercept": bool(include_intercept),
            "route": str(route),
        }
        arrays = {
            "params": np.asarray(params),
            "order_index": order_index,
            "criterion": np.asarray(criterion),
            "status": np.asarray(status, np.int8),
            "orders": orders,
        }

        def _write(f):
            np.savez(f, meta=np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8), **arrays)

        if self.fence is not None:
            # the fencing contract: the token check precedes the bytes —
            # a zombie primary raises FencedError HERE, before the
            # survivor's warm state can be clobbered
            self.fence()
        os.makedirs(self.root, exist_ok=True)
        journal_mod.durable_replace(self.path(tenant), _write,
                                    fault_kind="profile")
        with self._lock:
            self._cache.pop(tenant, None)
        if self.max_age_s is not None or self.max_profiles is not None:
            self.evict()
        prof = dict(meta)
        prof.update(arrays)
        return prof

    def evict(self, now: Optional[float] = None) -> List[str]:
        """Reap expired and over-count profiles; returns evicted tenants.

        Age expiry first (``updated_at`` older than ``max_age_s``; a
        profile without the stamp — written before eviction existed —
        counts as oldest), then the count bound keeps the
        ``max_profiles`` NEWEST by ``updated_at``.  Each unlink is
        fenced like a write: on a fleet root only the leaseholder may
        reap, and a zombie dies in ``FencedError`` before the first
        delete.
        """
        now = float(self._clock()) if now is None else float(now)
        profs = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        for fn in names:
            if not fn.endswith(".npz") or fn.startswith(".tmp-"):
                continue
            path = os.path.join(self.root, fn)
            prof = self._read(path)
            if prof is None:
                continue
            profs.append((float(prof.get("updated_at", -1.0)),
                          str(prof["tenant"]), path))
        doomed = []
        if self.max_age_s is not None:
            doomed = [p for p in profs if now - p[0] > self.max_age_s]
            profs = [p for p in profs if now - p[0] <= self.max_age_s]
        if self.max_profiles is not None and len(profs) > self.max_profiles:
            profs.sort(key=lambda p: (p[0], p[1]))
            cut = len(profs) - self.max_profiles
            doomed.extend(profs[:cut])
        if not doomed:
            return []
        if self.fence is not None:
            # deletes obey the same zombie-writer discipline as writes
            self.fence()
        evicted = []
        for _, tenant, path in doomed:
            try:
                os.unlink(path)
            except OSError:
                continue
            evicted.append(tenant)
            with self._lock:
                self._cache.pop(tenant, None)
        return sorted(evicted)


def _winner_orders(orders: np.ndarray, order_index: np.ndarray) -> np.ndarray:
    """Per-row winning order TUPLES (``[B, 3]``; ``-1`` rows map to
    ``(-1, -1, -1)``) — the grid-independent spelling of a selection, so
    stability survives stepwise grids that grow between passes."""
    orders = np.asarray(orders, np.int64).reshape(-1, 3)
    idx = np.asarray(order_index, np.int64)
    out = np.full((idx.shape[0], 3), -1, np.int64)
    ok = idx >= 0
    out[ok] = orders[idx[ok]]
    return out

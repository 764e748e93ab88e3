"""Delta walks: incremental refit for appended and revised panels (port of
``reliability/delta.py``).

A walk that refits the whole panel from scratch when only a sliver of data
changed pays full-refit cost for a 1 % change (a market feed appends ticks
every minute).  The journal already makes chunks durable and warm starts
make refits cheap; what this module adds is a per-chunk content identity
and a planner that uses it:

- **Identity** — journal version 2 manifests record a
  ``chunk_fingerprint`` in every committed chunk entry: a strided content
  hash of the chunk's OWN rows (``journal.chunk_fingerprint``), computed
  host-streamed through ``ChunkSource.read_rows`` (or a sample of the
  tensor's rows, moved to the host — same bytes by the staging identity
  contract), so npz, host, and device residencies fingerprint a chunk
  identically.  The manifest's ``extra.chunk_fp_cols`` records how many
  leading DATA columns the fingerprints cover (a warm delta walk's panel
  carries init columns the fingerprints deliberately exclude).

- **Planning** — :func:`plan_delta` diffs a new panel against a committed
  journal and classifies each prior chunk:

  * **clean** — identical rows (fingerprint match, same time length):
    adopt the committed result byte-for-byte, ZERO compute.  Sound
    because the walk is deterministic: refitting identical rows under an
    identical config reproduces identical bytes, so adoption IS the
    from-scratch result.  Requires the prior config hash to match the
    new walk's (enforced by the driver before any compute).
  * **warm** — the chunk's history GREW (new time steps appended) but
    the old prefix is byte-identical: refit, warm-started from the
    journaled params via augmented init-param columns
    (:class:`WarmstartFit`).  Warm results are pinned against a
    warm-started full walk of the same augmented panel (iteration counts
    differ from a cold fit, so the cold walk is not the reference here).
  * **dirty / new** — revised rows, rows never committed, or rows beyond
    the prior panel: full refit.

- **Execution** — ``fit_chunked(delta_from=root)`` journals the delta
  walk into a NEW namespace: clean chunks are spliced in up front as
  ordinary commits (entry ``delta.class == "adopted"``, naming the source
  manifest), so the ordinary resume machinery skips them and the walk runs
  ONLY warm+dirty chunks — pipelining, prefetch and sources compose with
  no new driver code, and a SIGKILLed delta walk resumes without ever
  recomputing an adopted chunk.  ``delta_warmstart=False`` (exact mode)
  refits warm chunks cold, keeping the whole result bitwise-identical to a
  from-scratch cold walk of the new panel on the same chunk grid.

A prior journal that cannot support the contract is rejected LOUDLY
(:class:`StalePriorError`): version-1 manifests without chunk
fingerprints (still resumable, not delta-eligible), shrunk panels,
shrunk time axes, or a same-shape prior fitted under a different config.
A prior written by the reference package is such a prior: its config
hash names the reference's fit module, so no chunk is ever adopted across
packages.
"""

from __future__ import annotations

import inspect
import os
import zipfile
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from . import source as source_mod
from ..utils import optim
from .journal import (JournalError, TornManifestError, _host_array,
                      chunk_fingerprint, chunk_sample_steps)

__all__ = [
    "ChunkClass",
    "DeltaError",
    "DeltaPlan",
    "StalePriorError",
    "WarmstartFit",
    "assemble_params",
    "chunk_fp_fn",
    "delta_extra",
    "load_prior",
    "plan_delta",
    "warm_panel",
]


class DeltaError(JournalError):
    """A delta walk cannot be planned against this prior journal."""


class StalePriorError(DeltaError):
    """The prior journal is structurally incompatible with the new panel
    (or was fitted under a different configuration) — refit from scratch
    or point ``delta_from`` at the right journal."""


class ChunkClass(NamedTuple):
    """One span of the delta plan's grid."""

    lo: int
    hi: int
    cls: str  # "adopted" | "warm" | "dirty" | "new"


class DeltaPlan(NamedTuple):
    """The classified chunk grid of a delta walk (see module docstring).

    ``chunks`` covers ``[0, n_rows_new)`` exactly, ascending and
    disjoint; ``counts`` tallies the classes; ``adopted`` carries each
    clean chunk's prior manifest entry and its shard PATH (structurally
    checked at plan time so a torn prior shard downgrades to dirty, not
    into spliced bytes — adoption then copies the file's bytes
    verbatim); ``init`` is the ``[n_rows_new, k]``
    warm-start matrix (prior params on warm rows, NaN elsewhere — the
    :class:`WarmstartFit` wrapper zeroes non-finite inits), None when no
    warm chunk exists or ``warmstart=False``.
    """

    prior_dir: str
    manifest: dict
    grown: bool
    data_cols: int
    chunk_rows: int
    chunks: List[ChunkClass]
    counts: dict
    adopted: list  # [(prior_entry, shard_path), ...]
    k: Optional[int]
    init: Optional[np.ndarray]
    prior_config_hash: Optional[str]


# probe-and-compact engagement gates (module-level so tests can
# monkeypatch them): a warm chunk below _PROBE_MIN_ROWS is too small for
# the two-dispatch overhead to pay off, and a probe below _PROBE_MIN_ITERS
# would flag healthy warm rows as stragglers
_PROBE_MIN_ROWS = 64
_PROBE_MIN_ITERS = 4


def _probe_plan(fit_fn, rows: int, kw: dict):
    """``(full_iters, probe_iters)`` when the probe-and-compact economy
    can engage for this dispatch, else ``None`` (plain single-dispatch
    path).  Requires the inner fit to expose ``max_iters`` and
    ``init_params``, and enough rows/budget for the split to pay.  The
    full budget comes from the caller's pinned ``max_iters=`` kwarg when
    present, else from the fit signature's concrete default
    (``functools.partial`` bindings surface there)."""
    if rows < _PROBE_MIN_ROWS:
        return None
    try:
        sig = inspect.signature(fit_fn)
    except (TypeError, ValueError):
        return None
    if "max_iters" not in sig.parameters or \
            "init_params" not in sig.parameters:
        return None
    full = kw.get("max_iters", sig.parameters["max_iters"].default)
    if isinstance(full, bool) or not isinstance(full, int) or \
            full < 2 * _PROBE_MIN_ITERS:
        return None
    # probe budget: the lockstep dispatch pays for every iteration the
    # probe rides, so the budget is the economy's whole margin.  Warm
    # rows converge in a handful of steps while full // 8 still rides 12
    # of a 96-iter budget; full // 16 halves the probe's lockstep cost
    # and only moves rows converging inside [full//16, full//8) into
    # the straggler refit — same composite result, cheaper stage 1
    return int(full), max(_PROBE_MIN_ITERS, int(full) // 16)


class WarmstartFit:
    """Chunk fit function for a warm-started delta refit.

    The walk's panel is augmented ``[y (n_time) | init params (k)]``;
    each chunk fit slices its own init columns and hands them to the
    underlying model fit as ``init_params`` — per chunk, so the warm
    start rides any chunking or streaming.  Non-finite inits (dirty/new rows, or a failed
    prior row) are zeroed — the model's cold-ish default, mirroring the
    winners refit.  Run with ``resilient=False``: the sanitizer must
    never "repair" init-param columns.

    **Probe-and-compact**: a warm start converges most rows in a handful
    of iterations, but a lockstep batched optimizer still streams the
    WHOLE panel until its slowest row terminates.  Large dispatches
    therefore run in two stages: a full-width probe at ``max_iters //
    16``, then the straggler rows (still running when the probe budget
    lapsed) gathered into a ``optim.retry_cap``-aligned sub-batch and
    refit at the full budget FROM THE ORIGINAL INIT (pad tail drops on
    scatter).  The composite is *equivalent* to the single full-budget
    dispatch — identical convergence/status maps, params to optimizer
    tolerance — but NOT bitwise: the compacted refit runs on a different
    batch shape.  What resume leans on instead is DETERMINISM: the same
    dispatch replays the same bytes.  ``compact=False`` forces the exact
    single-dispatch path.

    The instance carries a stable ``__qualname__`` naming the inner fit
    and the column split, so ``journal.config_hash`` hashes the warm
    configuration deterministically across runs (a bare callable's repr
    would embed a memory address and break resume).  Because compaction
    changes the bytes a chunk commits, ``compact=False`` is part of the
    qualname: journals written in one mode must not silently adopt the
    other's chunks on resume.
    """

    def __init__(self, fit_fn, n_time: int, k: int, *, compact: bool = True):
        self.fit_fn = fit_fn
        self.n_time = int(n_time)
        self.k = int(k)
        self.compact = bool(compact)
        inner = (getattr(fit_fn, "__module__", "?") + "."
                 + getattr(fit_fn, "__qualname__", repr(fit_fn)))
        self.__qualname__ = (f"WarmstartFit({inner}, "
                             f"n_time={self.n_time}, k={self.k}"
                             + ("" if self.compact else ", compact=False")
                             + ")")

    def __call__(self, aug, *, align_mode=None, **kw):
        if not isinstance(aug, torch.Tensor):
            from ..models.base import to_device

            aug = to_device(aug, kw.get("device", "cuda"))
        y = aug[:, :self.n_time]
        init = aug[:, self.n_time:self.n_time + self.k]
        init = torch.where(torch.isfinite(init), init, 0.0)
        if align_mode is not None:
            kw["align_mode"] = align_mode
        plan = (_probe_plan(self.fit_fn, int(y.shape[0]), kw)
                if self.compact else None)
        if plan is None:
            return self.fit_fn(y, init_params=init, **kw)
        _, probe_iters = plan
        # the probe's max_iters OVERRIDES a caller-pinned budget; the
        # straggler sub-dispatch (and the too-many-stragglers bail) keep
        # the caller's kw untouched, i.e. the full budget
        probe_kw = {k2: v for k2, v in kw.items() if k2 != "max_iters"}
        probe = self.fit_fn(y, init_params=init, max_iters=probe_iters,
                            **probe_kw)
        # the straggler set gates the second dispatch — a host decision
        # by design, exactly like the resilient ladder's retry gather
        iters = probe.iters.cpu().numpy()
        conv = probe.converged.cpu().numpy()
        stragglers = np.nonzero((iters >= probe_iters) & ~conv)[0]
        if stragglers.size == 0:
            return probe
        cap = optim.retry_cap(int(stragglers.size))
        if 2 * cap > int(y.shape[0]):
            # too many stragglers for the compacted shape to pay: eat the
            # probe and run the plain full-budget dispatch
            return self.fit_fn(y, init_params=init, **kw)
        gi = torch.as_tensor(optim.gather_pad_indices(stragglers, cap),
                             device=y.device)
        sub = self.fit_fn(y[gi], init_params=init[gi], **kw)
        rows = torch.as_tensor(stragglers, device=y.device)
        n = int(stragglers.size)
        out = []
        for field in probe._fields:
            pv, sv = getattr(probe, field), getattr(sub, field)
            if pv is None or sv is None:
                out.append(pv)
                continue
            merged = pv.clone()
            merged[rows] = sv[:n]
            out.append(merged)
        return type(probe)(*out)

    def __repr__(self):
        return self.__qualname__


def chunk_fp_fn(src, yb, data_cols: int):
    """``fp(lo, hi) -> str`` sampler over ONE panel residency.

    ``src`` (a :class:`~.source.ChunkSource`) streams sampled rows on the
    host through ``read_rows``; ``yb`` (a tensor, on any device) slices
    the strided sample where it lives and moves only that to the host.  Both hash the identical bytes (the staging
    identity contract: a staged chunk IS ``panel[lo:hi]``), so journals
    written from any residency agree on every chunk fingerprint.
    ``data_cols`` bounds the hash to the panel's leading DATA columns —
    a warm delta walk's init columns never reach the fingerprint, which
    is what lets tick-feed chains delta from a warm journal.
    """
    cols = int(data_cols)
    if src is not None:
        t_full = int(src.shape[1])
        dtype = src.dtype

        def fp(lo: int, hi: int) -> str:
            lo, hi = int(lo), int(hi)
            n = hi - lo
            sr, sc = chunk_sample_steps(n, cols)
            rows = range(lo, hi, sr)
            buf = np.empty((1, t_full), dtype)
            sample = np.empty((len(rows), len(range(0, cols, sc))), dtype)
            for i, r in enumerate(rows):
                src.read_rows(r, r + 1, buf)
                sample[i] = buf[0, :cols:sc]
            return chunk_fingerprint(sample, n, cols)
    else:

        def fp(lo: int, hi: int) -> str:
            lo, hi = int(lo), int(hi)
            n = hi - lo
            sr, sc = chunk_sample_steps(n, cols)
            # commit-path content fingerprint: the sample's copy to the
            # host runs on the committer thread next to the result fetch,
            # never on the driver's launch path
            sample = _host_array(yb[lo:hi:sr, :cols:sc])
            return chunk_fingerprint(sample, n, cols)

    return fp


def load_prior(prior_root: str) -> dict:
    """The prior job's root manifest, with torn/missing writes loud."""
    import json

    root = os.path.abspath(os.fspath(prior_root))
    path = os.path.join(root, "manifest.json")
    if not os.path.exists(path):
        raise DeltaError(
            f"delta_from={root} holds no manifest.json — a delta walk "
            "needs a COMMITTED prior journal (for a sharded prior, the "
            "merged root manifest)")
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TornManifestError(
            f"prior manifest {path} does not parse ({e}); inspect/remove "
            "the journal explicitly before planning a delta against it."
        ) from e


def _load_shard(root: str, entry: dict) -> Optional[dict]:
    """A committed chunk's result arrays, None when the shard is
    unreadable (the planner downgrades it to dirty — adoption must never
    splice torn bytes)."""
    path = os.path.join(root, entry["shard"])
    try:
        with np.load(path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in
                      ("params", "nll", "converged", "iters", "status")}
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if arrays["params"].shape[0] != entry["hi"] - entry["lo"]:
        return None
    return arrays


def _check_shard(root: str, entry: dict) -> Optional[str]:
    """Light structural check of a prior shard (zip directory + member
    headers, no decompression): the adoption fast path COPIES the file's
    bytes, so the planner only needs to know the shard is whole and
    holds the expected arrays at the expected row count.  Returns the
    path, or None (downgrade to dirty) when damaged."""
    path = os.path.join(root, entry["shard"])
    try:
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
            if {"params.npy", "nll.npy", "converged.npy", "iters.npy",
                    "status.npy"} - names:
                return None
            from .source import _npz_member_header

            shape, _dt = _npz_member_header(zf, "params.npy")
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if not shape or int(shape[0]) != int(entry["hi"]) - int(entry["lo"]):
        return None
    return path


def assemble_params(manifest: dict, root: str):
    """``[n_rows, k]`` params assembled from the committed shards (NaN on
    uncovered rows), or ``(None, None)`` when nothing committed."""
    params = None
    for e in manifest.get("chunks", []):
        if e.get("status") != "committed":
            continue
        arrays = _load_shard(root, e)
        if arrays is None:
            continue
        p = np.asarray(arrays["params"])
        if params is None:
            params = np.full((int(manifest["n_rows"]), p.shape[1]),
                             np.nan, p.dtype)
        if p.shape[1] == params.shape[1]:
            params[int(e["lo"]):int(e["hi"])] = p
    if params is None:
        return None, None
    return params, int(params.shape[1])


def plan_delta(prior_root, panel, *, chunk_rows: Optional[int] = None,
               warmstart: bool = True) -> DeltaPlan:
    """Classify every chunk of ``panel`` against the committed journal at
    ``prior_root`` (see module docstring for the classes and their
    contracts).  ``panel`` is a device/host array or any
    :class:`~.source.ChunkSource`; ``chunk_rows`` defaults to the prior
    walk's, keeping the grids aligned.  Raises :class:`StalePriorError`
    for priors that cannot support a delta (no chunk fingerprints,
    shrunk rows/time)."""
    root = os.path.abspath(os.fspath(prior_root))
    m = load_prior(root)

    if isinstance(panel, source_mod.ChunkSource):
        if isinstance(panel, source_mod.DeviceChunkSource):
            src, yb = None, panel.array
            b, t_new = int(yb.shape[0]), int(yb.shape[1])
        else:
            src, yb = panel, None
            b, t_new = int(panel.shape[0]), int(panel.shape[1])
    else:
        src, yb = None, panel
        if yb.ndim != 2:
            raise ValueError(
                f"expected [batch, time], got {tuple(yb.shape)}")
        b, t_new = int(yb.shape[0]), int(yb.shape[1])

    committed = [e for e in m.get("chunks", [])
                 if e.get("status") == "committed"]
    if committed and any("chunk_fingerprint" not in e for e in committed):
        raise StalePriorError(
            f"prior journal {root} has committed chunks without "
            "chunk_fingerprint entries (journal version "
            f"{m.get('journal_version')}, written before delta support). "
            "It remains fully RESUMABLE, but a delta walk cannot prove "
            "which chunks are unchanged — run one full refit with this "
            "code (writing a version-2 manifest), then delta from that.")
    prior_cols = int((m.get("extra") or {}).get("chunk_fp_cols")
                     or ((m.get("extra") or {}).get("panel") or {})
                     .get("time") or 0)
    if prior_cols <= 0:
        raise StalePriorError(
            f"prior journal {root} records no chunk_fp_cols/panel "
            "geometry; cannot align its chunk fingerprints with the new "
            "panel — run one full refit to refresh the manifest.")
    b_prior = int(m.get("n_rows", 0))
    if b < b_prior:
        raise StalePriorError(
            f"new panel has {b} rows but the prior journal fitted "
            f"{b_prior}; rows disappeared — a delta cannot reconcile a "
            "shrunk panel (refit from scratch).")
    if t_new < prior_cols:
        raise StalePriorError(
            f"new panel has {t_new} time steps but the prior journal's "
            f"chunks fingerprint {prior_cols}; the time axis shrank — a "
            "delta cannot reconcile truncated history (refit from "
            "scratch).")
    grown = t_new > prior_cols

    step = int(chunk_rows or m.get("chunk_rows") or b_prior or b)
    step = max(1, min(step, b))
    if not grown and int(m.get("chunk_rows") or 0) != step:
        # adoption splices prior-grid chunks into this walk's grid; a
        # mismatch would mix chunk shapes (and, sharded, overlap lanes).
        # The config hash covers chunk_rows too, but this names the
        # actual problem instead of a bare hash mismatch.
        raise StalePriorError(
            f"prior journal {root} walked a {m.get('chunk_rows')}-row "
            f"chunk grid but this walk uses {step}; adoption requires "
            "the SAME grid — pass chunk_rows to match (or omit it: the "
            "delta defaults to the prior grid).")

    fp = chunk_fp_fn(src, yb, prior_cols)
    chunks: List[ChunkClass] = []
    adopted: list = []
    warm_spans: list = []
    counts = {"adopted": 0, "warm": 0, "dirty": 0, "new": 0}

    def _note(lo, hi, cls):
        chunks.append(ChunkClass(int(lo), int(hi), cls))
        counts[cls] += 1

    def _fill(lo, hi, cls):
        # an uncovered region starts at a committed boundary, exactly
        # where the walk will dispatch from — split it on the grid step
        # the walk will use
        pos = int(lo)
        while pos < hi:
            _note(pos, min(pos + step, hi), cls)
            pos = min(pos + step, hi)

    pos = 0
    for e in sorted(committed, key=lambda e: e["lo"]):
        lo, hi = int(e["lo"]), int(e["hi"])
        if lo > pos:
            _fill(pos, lo, "dirty")  # never committed in the prior walk
        same = fp(lo, hi) == e.get("chunk_fingerprint")
        # adoption must land on the grid the cold walk would chunk: an
        # off-grid prior boundary (OOM backoff, or a trailing partial
        # chunk with rows appended after it) would shift every
        # downstream computed chunk's shape — and chunk SHAPE ties the
        # lockstep optimizer's low-order result bits, silently breaking
        # the bitwise-vs-cold-walk contract.  hi == b is the one legal
        # off-grid end: the panel truly ends there in BOTH walks.
        aligned = lo % step == 0 and (hi % step == 0 or hi == b)
        if same and not grown and aligned:
            shard_path = _check_shard(root, e)
            if shard_path is None:
                _note(lo, hi, "dirty")  # prior shard torn: recompute
            else:
                _note(lo, hi, "adopted")
                adopted.append((e, shard_path))
        elif same and grown and warmstart:
            _note(lo, hi, "warm")
            warm_spans.append((lo, hi))
        else:
            _note(lo, hi, "dirty")
        pos = hi
    if pos < b_prior:
        _fill(pos, b_prior, "dirty")
    if b > b_prior:
        _fill(b_prior, b, "new")

    k = init = None
    if warm_spans:
        params, k = assemble_params(m, root)
        if params is None:
            # nothing committed durably enough to warm from: recompute
            chunks = [ChunkClass(lo, hi, "dirty" if cls == "warm" else cls)
                      for lo, hi, cls in chunks]
            counts["dirty"] += counts.pop("warm")
            counts["warm"] = 0
            warm_spans = []
        else:
            dtype = (src.dtype if src is not None
                     else _host_array(yb[:0, :0]).dtype)
            init = np.full((b, k), np.nan, dtype)
            for lo, hi in warm_spans:
                init[lo:hi] = params[lo:hi].astype(dtype)

    return DeltaPlan(
        prior_dir=root, manifest=m, grown=grown, data_cols=prior_cols,
        chunk_rows=step, chunks=chunks, counts=counts, adopted=adopted,
        k=k, init=init, prior_config_hash=m.get("config_hash"))


def warm_panel(panel, init: np.ndarray):
    """The augmented ``[y | init params]`` panel in the input's own
    residency: a tensor concatenates on its device; a
    :class:`~.source.ChunkSource` composes into a streaming
    ``ColumnBlockSource`` serving the init columns from host RAM (byte
    positions identical either way)."""
    init = np.asarray(init)
    if isinstance(panel, source_mod.ChunkSource) and not isinstance(
            panel, source_mod.DeviceChunkSource):
        # lazy: forecasting composes on reliability, not the reverse —
        # ColumnBlockSource is pure source machinery and safe to borrow
        from ..forecasting.augment import ColumnBlockSource

        return ColumnBlockSource(
            [(panel, 0, int(panel.shape[1])),
             np.ascontiguousarray(init.astype(panel.dtype))])
    yb = (panel.array if isinstance(panel, source_mod.DeviceChunkSource)
          else panel)
    if not isinstance(yb, torch.Tensor):
        from ..models.base import to_device

        yb = to_device(yb, "cuda")
    return torch.cat(
        [yb, torch.as_tensor(init, dtype=yb.dtype, device=yb.device)], dim=1)


def delta_extra(plan: DeltaPlan, *, warmstart: bool, data_cols: int) -> dict:
    """The manifest ``extra.delta`` provenance block: where the adopted
    chunks came from, what the plan decided, and how many data columns
    the new walk's chunk fingerprints cover.  ``tools/obs_report.py
    --check`` validates the block (counts sum to the grid, adopted
    entries name their source manifest); ``tools/advise_budget.py``
    turns the dirty fraction into advice."""
    return {
        "from": plan.prior_dir,
        "source_manifest": os.path.join(plan.prior_dir, "manifest.json"),
        "prior_run_id": plan.manifest.get("run_id"),
        "prior_config_hash": plan.prior_config_hash,
        "warmstart": bool(warmstart),
        "data_cols": int(data_cols),
        "counts": dict(plan.counts),
        "chunks": [[c.lo, c.hi, c.cls] for c in plan.chunks],
    }

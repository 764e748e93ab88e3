"""Write-ahead chunk journal: whole-job durability for panel fits (port of
``reliability/journal.py``, without its multi-lane half).

Upstream spark-timeseries inherited *job-level* durability from Spark
itself: RDD lineage meant a lost executor or a preempted node only
recomputed its partitions, and a restarted driver replayed the DAG from the
last materialized stage.  Here a multi-chunk panel fit runs in one Python
process, so a SIGKILL, a preempted machine or a hung kernel build at chunk
7 of 8 would lose every finished chunk.  This module is the replacement
lineage: a directory holding

- one **npz result shard per committed chunk** (params / nll / converged /
  iters / status for its row range), written tmp-then-``os.replace`` so a
  shard either exists whole or not at all; and
- an atomically updated **JSON manifest** recording the run id, git commit,
  panel fingerprint, fit-config hash, and — per chunk — the row range,
  status (``committed`` / ``TIMEOUT``), ``FitStatus`` counts, wall time,
  peak device memory, and (journal version 2) a per-chunk
  **content fingerprint** of the chunk's own rows — the identity the
  delta planner (:mod:`.delta`) diffs against a new panel to refit only
  what changed.

Write-ahead ordering: the shard is durable *before* the manifest names it,
so a crash between the two leaves an orphan shard that is simply
recomputed — the manifest never references bytes that might not exist.

**Resume contract** (``reliability.fit_chunked(..., checkpoint_dir=...)``):
on restart with the same panel and fit config, committed chunks load from
their shards and only pending/TIMEOUT chunks recompute, producing results
bitwise-identical to an uninterrupted run (same chunk boundaries -> the
same kernels over the same rows; a chunk's committed bytes ARE the bytes
the uninterrupted run produced).  A manifest whose config hash or panel
fingerprint does not match is STALE — resuming under it would splice rows
fitted under a different model/config into the result — and is rejected
loudly (:class:`StaleJournalError`); an unparseable manifest is a torn
write from a mid-commit crash of a non-atomic filesystem and is also
rejected (:class:`TornManifestError`) rather than silently started over.

**Identity across packages**: the hashing (:func:`config_hash`,
:func:`panel_fingerprint`, :func:`chunk_fingerprint`) and the file protocol
are the reference's, byte for byte: the same bytes give the same hex, and
a tensor on any device hashes its host copy (only the strided sample
crosses to the host).  :func:`config_hash` names the fit function's module,
so a journal written by this package and one written by the reference
never adopt each other's chunks.

**Namespaces**: ``process_index`` other than 0 journals under
``proc_00001/...`` with a process-local manifest, and ``shard_index``
under ``shard_00000/...``; only process 0 commits the job-level
``manifest.json``.  :func:`check_root_manifest` rejects a foreign job's
root manifest.  A sharded walk's lanes read each other's namespaces
through :class:`ShardJournalView` (an elastic lane adopts a peer's
commits), and shard/process 0 folds the namespaces into ONE root
manifest with :func:`merge_job_manifest` (warmed by :class:`MergeWarmer`
while the last lanes finish).

**Leases** (the end of the module) are the fleet's single-writer election:
a pure file protocol of claim files and a heartbeat record.
"""

from __future__ import annotations

import errno
import functools
import hashlib
import json
import os
import subprocess
import tempfile
import threading
import time
import uuid
import zipfile
from typing import Callable, Optional

import numpy as np
import torch

from .. import obs

__all__ = [
    "ChunkJournal",
    "FencedError",
    "JournalError",
    "Lease",
    "LeaseError",
    "LoadedChunk",
    "MergeWarmer",
    "ShardJournalView",
    "StaleJournalError",
    "TornManifestError",
    "acquire_lease",
    "chunk_fingerprint",
    "chunk_sample_steps",
    "config_hash",
    "check_root_manifest",
    "consult_disk_fault",
    "durable_replace",
    "highest_claim",
    "lease_is_live",
    "merge_job_manifest",
    "panel_fingerprint",
    "read_lease",
    "set_disk_fault_hook",
    "tear_after_replace",
]

# version 2: manifest chunk entries gain a per-chunk content
# fingerprint (``chunk_fingerprint``) next to the panel-wide
# ``panel_fingerprint`` — the identity a delta walk (reliability.delta)
# diffs to adopt unchanged chunks.  Version-1 manifests stay RESUMABLE
# (resume never checks the version; entries without the field simply
# recompute nothing new) but are not delta-eligible — the planner
# rejects them with an explanatory error.
JOURNAL_VERSION = 2
MANIFEST = "manifest.json"
RESUME_MODES = ("auto", "require", "never")


class JournalError(RuntimeError):
    """Base class for journal failures."""


class TornManifestError(JournalError):
    """The manifest exists but does not parse — a torn/partial write."""


class StaleJournalError(JournalError):
    """The manifest belongs to a different panel or fit configuration."""


class LeaseError(JournalError):
    """Base class for lease-protocol failures."""


class FencedError(LeaseError):
    """A stale-token holder tried to act on a root it no longer owns.

    The fencing contract: every durable write a lease holder
    performs is preceded by a token check, and a holder whose token is no
    longer the highest claim LOSES LOUDLY — it must stop writing, never
    fall back to best-effort.  Raised by :meth:`Lease.check` (and so by
    every fenced write path in ``serving.fleet``)."""


def _host_array(v) -> np.ndarray:
    """``v`` as a host numpy array: a tensor (on any device) is detached and
    copied to the host; anything else goes through ``np.asarray``."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _array_digest(v) -> str:
    """Shape + dtype + content digest of an array-valued fit kwarg.

    Contents MUST count: two ``init_params`` arrays of equal shape are
    different fit configurations, and accepting a journal across them
    would splice rows fitted under the other init.  Large arrays hash a
    deterministic strided subsample (same trust argument as
    :func:`panel_fingerprint`); a tensor takes its subsample on its own
    device and moves only that to the host."""
    shape = tuple(int(n) for n in np.shape(v))
    a = v.detach() if isinstance(v, torch.Tensor) else np.asarray(v)
    size = int(np.prod(shape, dtype=np.int64))
    if size > 1 << 20:
        step = -(-size // (1 << 20))
        a = a.reshape(-1)[::step]
    a = _host_array(a)
    dtype = a.dtype
    digest = hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:12]
    return f"array{shape}:{dtype}:{digest}"


def config_hash(fit_fn: Callable, fit_kwargs: dict,
                extra: Optional[dict] = None) -> str:
    """Stable hash of everything that decides what a chunk's bytes mean.

    Covers the fit function's identity (``functools.partial`` layers are
    unwrapped and their bound arguments included), every fit kwarg (arrays
    by shape, dtype, AND a content digest — a different ``init_params`` is
    a different config), and driver-level knobs passed via ``extra``
    (chunk size, resilient mode, ...).  Two runs with equal hashes over
    the same panel produce interchangeable shards; a mismatch on resume
    means the journal is stale and must not be spliced into the new run.
    """
    layers = []
    f = fit_fn
    while isinstance(f, functools.partial):
        layers.append([
            repr(tuple(_enc(a) for a in f.args)),
            repr(sorted((k, _enc(v)) for k, v in (f.keywords or {}).items())),
        ])
        f = f.func
    name = (getattr(f, "__module__", "?") + "."
            + getattr(f, "__qualname__", repr(f)))
    kv = sorted((k, _enc(v)) for k, v in fit_kwargs.items())
    ex = sorted((k, _enc(v)) for k, v in (extra or {}).items())
    blob = json.dumps([name, layers, kv, ex], default=repr)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _enc(v):
    """Hashable text encoding of one fit-kwarg value (see config_hash)."""
    if hasattr(v, "shape") and hasattr(v, "dtype"):
        return _array_digest(v)
    return repr(v)


def panel_fingerprint(y, max_side: int = 256) -> str:
    """Cheap content fingerprint of a ``[B, T]`` panel.

    Hashes the shape, dtype, and a deterministic strided subsample of at
    most ``max_side**2`` raw values (bit patterns, so NaN placement
    counts).  The subsample keeps the device->host transfer a few hundred
    KB even for the million-series panel; a journal is rejected as stale
    when the fingerprint differs, so collisions only risk *accepting* a
    journal for a panel that agrees on every sampled byte — the same
    trust level a size+mtime check gives, at content strength.
    """
    b, t = int(y.shape[0]), int(y.shape[1])
    sr, sc = max(1, -(-b // max_side)), max(1, -(-t // max_side))
    # the sample is taken where the panel lives: a tensor on the card
    # moves only its strided sample to the host
    sample = np.ascontiguousarray(_host_array(y[::sr, ::sc]))
    h = hashlib.sha256()
    h.update(f"{b}x{t}:{sample.dtype}".encode())
    h.update(sample.tobytes())
    return h.hexdigest()[:16]


# side cap for the per-chunk fingerprint's strided subsample: chunks are
# already row-bounded, so a smaller cap than panel_fingerprint's keeps
# the per-commit hashing cost (and, for device panels, the D2H sample
# transfer on the committer thread) negligible next to the result fetch
CHUNK_FP_MAX_SIDE = 128


def chunk_sample_steps(n_rows: int, n_cols: int,
                       max_side: int = CHUNK_FP_MAX_SIDE):
    """(row_step, col_step) of the deterministic strided subsample a
    chunk fingerprint hashes.  Shared by every residency's sampler
    (device slice, host array, streamed source rows) so npz/host/device
    walks fingerprint a chunk's rows identically."""
    return (max(1, -(-int(n_rows) // max_side)),
            max(1, -(-int(n_cols) // max_side)))


def chunk_fingerprint(sample: np.ndarray, n_rows: int, n_cols: int) -> str:
    """Content fingerprint of one chunk's rows.

    ``sample`` is the chunk's strided subsample (``chunk_sample_steps``
    over rows ``[lo, hi)`` and the chunk's DATA columns) — raw bit
    patterns, so NaN placement counts, exactly like
    :func:`panel_fingerprint` but per chunk.  The delta planner
    (:mod:`.delta`) compares these across two panels to classify a chunk
    clean (identical rows — adopt the committed result), warm (history
    grew, prefix identical), or dirty (revised).  Same trust argument as
    the panel fingerprint: a mismatch always recomputes; a collision
    only risks adopting a chunk that agrees on every sampled byte.
    """
    sample = np.ascontiguousarray(sample)
    h = hashlib.sha256()
    h.update(f"chunk{int(n_rows)}x{int(n_cols)}:{sample.dtype}".encode())
    h.update(sample.tobytes())
    return h.hexdigest()[:16]


def _git_commit(root: Optional[str] = None) -> Optional[str]:
    try:
        out = subprocess.run(
            ["git", "-C", root or os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__)))),
             "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=10,
        )
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


# -- disk-fault seam ---------------------------------------------
# reliability.faultinject installs a hook here so tier-1 CPU tests can
# drive EIO / ENOSPC / torn-at-fsync faults through the real durable
# write paths (journal shards, serving write-ahead records, stored
# results) without a faulty device.  Production never sets a hook; the
# consult is a single None check.

_disk_fault_hook: Optional[Callable] = None


def set_disk_fault_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install (or clear, with None) the process-wide disk-fault hook;
    returns the previous hook so tests can restore it.  The hook is
    called as ``hook(path, kind)`` before each guarded durable write and
    answers ``None``/``"pass"`` (write normally), ``"eio"``/``"enospc"``
    (raise the matching ``OSError`` before any bytes land), or
    ``"torn"`` (write, then truncate the final file to a prefix — a
    lying fsync)."""
    global _disk_fault_hook
    prev = _disk_fault_hook
    _disk_fault_hook = hook
    return prev


def consult_disk_fault(path: str, kind: str) -> Optional[str]:
    """Ask the installed hook about one durable write (see
    :func:`set_disk_fault_hook`).  Raises the injected ``OSError`` for
    ``eio``/``enospc``; returns ``"torn"`` when the caller must tear the
    file AFTER its replace lands, else None."""
    hook = _disk_fault_hook
    if hook is None:
        return None
    verdict = hook(path, kind)
    if verdict in (None, "pass"):
        return None
    if verdict == "eio":
        raise OSError(errno.EIO,
                      f"injected I/O error on {kind} write", path)
    if verdict == "enospc":
        raise OSError(errno.ENOSPC,
                      f"injected no-space error on {kind} write", path)
    if verdict == "torn":
        return "torn"
    raise ValueError(f"unknown disk-fault verdict {verdict!r}")


def tear_after_replace(path: str) -> None:
    """Truncate a just-replaced durable file to a half prefix — the
    "fsync lied" fault: the rename landed but the device persisted only
    part of the data.  Readers must treat the file as torn (CRC/npz
    parse failure), never as silently shorter data."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(1, size // 2))


def durable_replace(path: str, write: Callable, *,
                    suffix: Optional[str] = None,
                    fault_kind: str = "durable") -> None:
    """The ONE durable-file primitive: ``write(f)`` into a hidden tmp in
    the target's directory, fsync, ``os.replace`` — the final path holds
    a whole file (or its previous content), never a torn write, and a
    crash leaves only a hidden ``.tmp-*`` orphan every reader ignores.
    Shared by the journal's shard/manifest writes, adoption's byte
    splices, and the npz append helpers, so the crash-safety sequence
    lives in one place (which is also why the disk-fault seam guards
    exactly here — ``fault_kind`` names the write class for the hook)."""
    verdict = consult_disk_fault(path, fault_kind)
    d = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(
        dir=d, prefix=".tmp-",
        suffix=os.path.basename(path) if suffix is None else suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if verdict == "torn":
        tear_after_replace(path)


def _atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp -> fsync -> ``os.replace``: the file is whole or absent."""
    durable_replace(path, lambda f: f.write(data))


class LoadedChunk:
    """A committed chunk rehydrated from its shard (duck-types the result
    pieces ``fit_chunked`` assembles: ``params`` / ``neg_log_likelihood`` /
    ``converged`` / ``iters`` / ``status`` / ``meta``)."""

    __slots__ = ("params", "neg_log_likelihood", "converged", "iters",
                 "status", "meta")

    def __init__(self, z, entry: dict):
        self.params = z["params"]
        self.neg_log_likelihood = z["nll"]
        self.converged = z["converged"]
        self.iters = z["iters"]
        self.status = z["status"]
        self.meta = {"resumed_from_journal": True, "lo": entry["lo"],
                     "hi": entry["hi"]}


class ChunkJournal:
    """Directory-backed chunk journal (see module docstring).

    ``resume``: ``"auto"`` adopts a compatible existing manifest (and
    starts fresh when none exists), ``"require"`` demands one,
    ``"never"`` ignores any prior state and starts a fresh run (existing
    entries are dropped from the new manifest; shard files are
    overwritten as their chunks recommit).  Stale and torn manifests
    raise under every mode — deleting a journal is the operator's
    explicit act, never a side effect.

    ``process_index`` selects the namespace: process 0 owns the job-level
    ``manifest.json`` at the directory root; every other process works
    under ``proc_{i:05d}/`` with a manifest named for it, so concurrent
    multi-host writers never race on one file.  ``shard_index`` (sharded
    chunk walks) namespaces one lane of ONE job the same way — the journal
    lives under ``shard_{i:05d}/`` with a manifest named for the shard,
    regardless of process (a shard id is globally unique across the
    mesh's processes), and the job-level root ``manifest.json`` is written
    only by the job-manifest merge after the lanes join
    (:func:`merge_job_manifest`).  A shard
    journal whose recorded span (``extra`` keys ``shard_lo``/``shard_hi``/
    ``n_shards``) does not match the new run's lane layout is STALE: the
    mesh changed, and resuming would replay another lane's boundaries.

    ``commit_hook(event, lo)`` is a test/fault-injection surface called
    with ``"shard_written"`` (shard durable, manifest not yet updated) and
    ``"committed"`` (manifest updated) — ``reliability.faultinject`` uses
    it to kill the process at either point.
    """

    # lock-discipline contract (tools/lint lock-map): the pipelined
    # committer commits from its worker thread while the driver reads
    # resume state and elastic lanes adopt entries cross-namespace —
    # the manifest map and its index mutate only under the reentrant
    # _mu (single-WRITER protocol unchanged: one committer between
    # submit and drain).
    _protected_by_ = {
        "_manifest": "_mu",
        "_by_lo": "_mu",
        "resumed_entries": "_mu",
    }

    def __init__(
        self,
        directory: str,
        *,
        config_hash: str,
        panel_fingerprint: str,
        n_rows: int,
        chunk_rows: int,
        resume: str = "auto",
        process_index: int = 0,
        shard_index: Optional[int] = None,
        extra: Optional[dict] = None,
        commit_hook: Optional[Callable[[str, int], None]] = None,
        chunk_fp: Optional[Callable[[int, int], str]] = None,
    ):
        if resume not in RESUME_MODES:
            raise ValueError(f"resume must be one of {RESUME_MODES}, got {resume!r}")
        self.process_index = int(process_index)
        self.shard_index = None if shard_index is None else int(shard_index)
        root = os.path.abspath(directory)
        if self.shard_index is not None:
            # one lane of a sharded walk: shard ids are globally unique
            # across the mesh's processes, so the shard namespace alone
            # keeps concurrent writers apart (no proc_ nesting needed)
            self.dir = os.path.join(root, f"shard_{self.shard_index:05d}")
        else:
            self.dir = root if self.process_index == 0 else os.path.join(
                root, f"proc_{self.process_index:05d}")
        os.makedirs(self.dir, exist_ok=True)
        if self.shard_index is not None:
            manifest_name = f"manifest.shard_{self.shard_index:05d}.json"
        elif self.process_index == 0:
            manifest_name = MANIFEST
        else:
            manifest_name = f"manifest.proc_{self.process_index:05d}.json"
        self.manifest_path = os.path.join(self.dir, manifest_name)
        self.config_hash = config_hash
        self.panel_fingerprint = panel_fingerprint
        self.n_rows = int(n_rows)
        self.run_id = uuid.uuid4().hex[:12]  # lint: nondet(run identity metadata, never hashed into results)
        self._commit_hook = commit_hook
        # per-chunk content fingerprint callback: the driver
        # supplies a sampler over ITS panel residency; every committed
        # entry then records `chunk_fingerprint`, the identity a later
        # delta walk diffs to adopt unchanged chunks.  None (multi-process
        # global arrays, external callers) simply leaves the field off —
        # resumable as ever, not delta-eligible.
        self._chunk_fp = chunk_fp
        self.resumed_entries = 0
        # the pipelined chunk driver commits from a background committer
        # thread while the driver thread reads resume state
        # (committed / next_committed_lo); one reentrant lock keeps the
        # manifest map coherent without changing the single-WRITER protocol
        # (the committer is the only writer between submit and drain)
        self._mu = threading.RLock()

        prior = self._load_manifest() if resume != "never" else None
        if resume == "never":
            # a torn/stale manifest still must not be silently destroyed:
            # surface it even though we will not resume from it
            self._load_manifest()
        if resume == "require" and prior is None:
            raise JournalError(
                f"resume='require' but no manifest at {self.manifest_path}")
        if prior is not None and self.shard_index is not None:
            # a shard journal belongs to ONE lane layout: if the mesh (and
            # with it this shard's span) changed, replaying these chunks
            # would splice another lane's boundaries into the new walk
            pex = prior.get("extra") or {}
            nex = dict(extra or {})
            bad = [k for k in ("shard_lo", "shard_hi", "n_shards")
                   if k in nex and pex.get(k) != nex[k]]
            if bad:
                raise StaleJournalError(
                    f"{self.manifest_path} was written under a different "
                    f"shard layout ({'; '.join(f'{k} {pex.get(k)} != {nex[k]}' for k in bad)}). "
                    "Resume a sharded job with the same mesh/shard count, "
                    "or point checkpoint_dir at a fresh directory.")
        if prior is not None:
            self._manifest = prior
            head = _git_commit()
            if head and prior.get("git_commit") and head != prior["git_commit"]:
                # same config hash across a code upgrade can still mean
                # different numerics (a changed model default); surface it —
                # the operator decides whether mixed-code chunks are fine
                import warnings

                warnings.warn(
                    f"resuming journal {self.manifest_path} written at git "
                    f"commit {prior['git_commit'][:12]} from {head[:12]}: "
                    "committed chunks were fitted by the older code",
                    stacklevel=3,
                )
            self._manifest.setdefault("resumes", []).append(
                {"run_id": self.run_id, "at": time.time(),  # lint: nondet(resume-history wall-clock metadata)
                 "git_commit": head})
        else:
            self._manifest = {
                "journal_version": JOURNAL_VERSION,
                "run_id": self.run_id,
                "created_at": time.time(),  # lint: nondet(manifest wall-clock metadata; never in fitted bytes)
                "git_commit": _git_commit(),
                "config_hash": config_hash,
                "panel_fingerprint": panel_fingerprint,
                "n_rows": self.n_rows,
                "chunk_rows": int(chunk_rows),
                "process_index": self.process_index,
                **({"shard_index": self.shard_index}
                   if self.shard_index is not None else {}),
                "extra": dict(extra or {}),
                "resumes": [],
                "chunks": [],
            }
            self._write_manifest()
        self._by_lo = {e["lo"]: e for e in self._manifest["chunks"]}

    # -- manifest I/O -------------------------------------------------------

    def _load_manifest(self) -> Optional[dict]:
        if not os.path.exists(self.manifest_path):
            return None
        try:
            with open(self.manifest_path, "rb") as f:
                m = json.loads(f.read().decode())
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise TornManifestError(
                f"{self.manifest_path} does not parse ({e}); a mid-commit "
                "crash tore the write. Inspect/remove the journal directory "
                "explicitly — it will not be silently overwritten."
            ) from e
        mismatches = []
        if m.get("config_hash") != self.config_hash:
            mismatches.append(
                f"config_hash {m.get('config_hash')} != {self.config_hash}")
        if m.get("panel_fingerprint") != self.panel_fingerprint:
            mismatches.append(
                f"panel_fingerprint {m.get('panel_fingerprint')} != "
                f"{self.panel_fingerprint}")
        if int(m.get("n_rows", -1)) != self.n_rows:
            mismatches.append(f"n_rows {m.get('n_rows')} != {self.n_rows}")
        if mismatches:
            raise StaleJournalError(
                f"{self.manifest_path} was written by a different run "
                f"({'; '.join(mismatches)}). Resuming would splice rows "
                "fitted under a different panel/config into this result; "
                "point checkpoint_dir at a fresh directory or remove the "
                "stale journal explicitly."
            )
        return m

    def _write_manifest(self) -> None:
        # _mu is reentrant: callers already hold it, and taking it here
        # keeps the declared lock-map discipline lexically visible
        with self._mu:
            # lint: nondet(manifest wall-clock metadata; never in fitted bytes)
            self._manifest["updated_at"] = time.time()
            _atomic_write_bytes(
                self.manifest_path,
                (json.dumps(self._manifest, indent=1,
                            sort_keys=True) + "\n").encode())

    # -- chunk lifecycle ----------------------------------------------------

    def _shard_name(self, lo: int, hi: int) -> str:
        return f"chunk_{lo:09d}_{hi:09d}.npz"

    def committed(self, lo: int) -> Optional[dict]:
        """The committed manifest entry starting at row ``lo``, if any."""
        with self._mu:
            e = self._by_lo.get(int(lo))
            return e if e is not None and e["status"] == "committed" else None

    def next_committed_lo(self, lo: int) -> Optional[int]:
        """Smallest committed-chunk start strictly beyond ``lo`` — the
        boundary a recomputing walk must not run past."""
        with self._mu:
            starts = [e["lo"] for e in self._manifest["chunks"]
                      if e["status"] == "committed" and e["lo"] > int(lo)]
        return min(starts) if starts else None

    def committed_crossing(self, pos: int) -> Optional[int]:
        """``hi`` of the once-committed chunk that strictly contains row
        ``pos`` (``lo < pos < hi``), or None.  The elastic steal path
        must never split a span inside such a chunk — a
        previous run's OOM backoff can leave off-grid boundaries — or
        thief and victim would both compute its rows.  ``shard-lost``
        entries (a committed chunk whose npz tore) count too: the walk
        recomputes them as FORCED boundaries pinned to the recorded
        ``[lo, hi)``, dispatching past any narrower steal split."""
        pos = int(pos)
        with self._mu:
            for e in self._manifest["chunks"]:
                if e["status"] in ("committed", "shard-lost") \
                        and e["lo"] < pos < e["hi"]:
                    return int(e["hi"])
        return None

    def load_chunk(self, entry: dict) -> Optional[LoadedChunk]:
        """Rehydrate a committed chunk; ``None`` (recompute) when the shard
        is missing or unreadable — a shard torn by a crash downgrades to a
        recompute, never to corrupt rows."""
        path = os.path.join(self.dir, entry["shard"])
        try:
            with np.load(path, allow_pickle=False) as z:
                piece = LoadedChunk({k: z[k] for k in
                                     ("params", "nll", "converged", "iters",
                                      "status")}, entry)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            with self._mu:
                entry["status"] = "shard-lost"
                self._write_manifest()
                self._by_lo.pop(entry["lo"], None)
            return None
        if piece.params.shape[0] != entry["hi"] - entry["lo"]:
            with self._mu:
                entry["status"] = "shard-lost"
                self._write_manifest()
                self._by_lo.pop(entry["lo"], None)
            return None
        with self._mu:  # elastic lanes may ADOPT from a peer namespace
            self.resumed_entries += 1  # concurrently; resumed =
        obs.counter("journal.chunks_resumed").inc()  # actually rehydrated
        return piece

    def _record(self, entry: dict) -> None:
        with self._mu:
            self._manifest["chunks"] = [
                e for e in self._manifest["chunks"] if e["lo"] != entry["lo"]]
            self._manifest["chunks"].append(entry)
            self._manifest["chunks"].sort(key=lambda e: e["lo"])
            self._by_lo[entry["lo"]] = entry
            self._write_manifest()
        if self._commit_hook is not None:
            # "committed" fires only for durable result chunks: a TIMEOUT
            # mark is bookkeeping, and kill_after_commits counting it would
            # shift the crash window the harness means to exercise
            event = ("committed" if entry["status"] == "committed"
                     else "timeout_recorded")
            self._commit_hook(event, entry["lo"])

    def commit_chunk(self, lo: int, hi: int, arrays: dict, **info) -> dict:
        """Write the shard durably, THEN name it in the manifest."""
        t0 = time.perf_counter()
        lo, hi = int(lo), int(hi)
        shard = self._shard_name(lo, hi)
        path = os.path.join(self.dir, shard)
        durable_replace(path, lambda f: np.savez(f, **arrays),
                        suffix=".npz")
        if self._commit_hook is not None:
            self._commit_hook("shard_written", lo)
        if self._chunk_fp is not None and "chunk_fingerprint" not in info:
            # computed on the committer thread, next to the result fetch
            # (a device panel's sampler pays a small D2H there, never on
            # the driver's dispatch path)
            info["chunk_fingerprint"] = self._chunk_fp(lo, hi)
        entry = {"lo": lo, "hi": hi, "status": "committed", "shard": shard,
                 "run_id": self.run_id, "committed_at": time.time(), **info}  # lint: nondet(commit wall-clock metadata; never in fitted bytes)
        self._record(entry)
        commit_s = time.perf_counter() - t0
        obs.histogram("journal.commit_s").observe(commit_s)
        obs.event("journal.commit", lo=lo, hi=hi,
                  commit_s=round(commit_s, 6))
        return entry

    def adopt_chunks(self, items) -> list:
        """Batch-commit ADOPTED chunks: every shard is written
        durably first (tmp -> fsync -> replace, like any commit), then
        ONE manifest update names them all.  Write-ahead ordering is
        preserved — a crash mid-batch leaves orphan shards the next
        delta walk simply re-adopts — while the delta walk's fixed cost
        drops from N manifest rewrites to one (the adoption path is the
        90%-of-chunks path; per-chunk manifest churn there would eat the
        speedup adoption exists to provide).

        ``items`` is ``[(lo, hi, payload, info), ...]`` where ``payload``
        is either a dict of result arrays (serialized like any commit) or
        a PATH to an existing shard npz whose bytes are copied verbatim —
        the adoption fast path: "byte-for-byte" is then literal, and the
        delta walk never round-trips the prior results through
        numpy.  Returns the recorded entries.  The commit hook sees every
        ``shard_written`` as shards land and every ``committed`` after
        the single manifest write, in item order.
        """
        def _splice(payload):
            def write(f):
                if isinstance(payload, (str, os.PathLike)):
                    with open(payload, "rb") as srcf:
                        while True:
                            block = srcf.read(1 << 20)
                            if not block:
                                break
                            f.write(block)
                else:
                    np.savez(f, **payload)
            return write

        entries = []
        for lo, hi, payload, info in items:
            t0 = time.perf_counter()
            lo, hi = int(lo), int(hi)
            shard = self._shard_name(lo, hi)
            path = os.path.join(self.dir, shard)
            durable_replace(path, _splice(payload), suffix=".npz")
            if self._commit_hook is not None:
                self._commit_hook("shard_written", lo)
            info = dict(info)
            if self._chunk_fp is not None and \
                    "chunk_fingerprint" not in info:
                info["chunk_fingerprint"] = self._chunk_fp(lo, hi)
            entries.append({"lo": lo, "hi": hi, "status": "committed",
                            "shard": shard, "run_id": self.run_id,
                            "committed_at": time.time(), **info})  # lint: nondet(commit wall-clock metadata; never in fitted bytes)
            obs.histogram("journal.commit_s").observe(
                time.perf_counter() - t0)
        with self._mu:
            keep = {e["lo"] for e in entries}
            self._manifest["chunks"] = [
                e for e in self._manifest["chunks"] if e["lo"] not in keep]
            self._manifest["chunks"].extend(entries)
            self._manifest["chunks"].sort(key=lambda e: e["lo"])
            for e in entries:
                self._by_lo[e["lo"]] = e
            self._write_manifest()
        for e in entries:
            if self._commit_hook is not None:
                self._commit_hook("committed", e["lo"])
            obs.event("journal.commit", lo=e["lo"], hi=e["hi"],
                      adopted=True)
        return entries

    def mark_timeout(self, lo: int, hi: int, **info) -> dict:
        """Record a chunk that overran its budget (no shard: a resume
        retries it — ``committed()`` skips non-committed entries)."""
        entry = {"lo": int(lo), "hi": int(hi), "status": "TIMEOUT",
                 "run_id": self.run_id, "committed_at": time.time(), **info}  # lint: nondet(commit wall-clock metadata; never in fitted bytes)
        self._record(entry)
        obs.event("journal.timeout", lo=int(lo), hi=int(hi))
        return entry

    def record_telemetry(self, telemetry: dict) -> None:
        """Embed the run's telemetry summary in the manifest (atomically
        rewritten), so post-mortems read compile/execute span times,
        counters, and peak memory from the journal alone
        (``tools/inspect_journal.py`` prints it, ``tools/obs_report.py
        --manifest`` validates it)."""
        with self._mu:
            self._manifest["telemetry"] = telemetry
            self._write_manifest()

    # -- summary ------------------------------------------------------------

    def accounting(self) -> dict:
        """Job-level journal metadata for result ``meta`` / bench artifacts."""
        with self._mu:
            chunks = list(self._manifest["chunks"])
        return {
            "dir": self.dir,
            "manifest": os.path.basename(self.manifest_path),
            "run_id": self.run_id,
            "config_hash": self.config_hash,
            "process_index": self.process_index,
            "chunks_committed": sum(1 for e in chunks
                                    if e["status"] == "committed"),
            "chunks_timeout": sum(1 for e in chunks
                                  if e["status"] == "TIMEOUT"),
            "chunks_resumed": self.resumed_entries,
            "resumes": len(self._manifest.get("resumes", [])),
        }


def check_root_manifest(directory: str, *, config_hash: str,
                        panel_fingerprint: str, n_rows: int) -> None:
    """Raise if the job-level ``manifest.json`` at ``directory`` belongs to
    a DIFFERENT job (config hash / panel fingerprint / row count mismatch)
    or is torn; no-op when absent or matching.

    A sharded walk's lanes only ever open shard namespaces, so without
    this check a foreign root manifest would survive untouched until the
    merge destroyed it — the single-device path rejects the same
    situation at ``ChunkJournal`` construction.
    """
    root_mp = os.path.join(os.path.abspath(directory), MANIFEST)
    if not os.path.exists(root_mp):
        return
    try:
        with open(root_mp, "rb") as f:
            prior = json.loads(f.read().decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise TornManifestError(
            f"{root_mp} does not parse ({e}); inspect/remove the journal "
            "directory explicitly — it will not be silently overwritten "
            "by a shard merge.") from e
    mismatches = []
    if prior.get("config_hash") != config_hash:
        mismatches.append("config_hash")
    if prior.get("panel_fingerprint") != panel_fingerprint:
        mismatches.append("panel_fingerprint")
    if int(prior.get("n_rows", -1)) != int(n_rows):
        mismatches.append("n_rows")
    if mismatches:
        raise StaleJournalError(
            f"root manifest {root_mp} belongs to a different job "
            f"({', '.join(mismatches)} mismatch); merging this sharded "
            "walk would destroy that job's durable state — use a fresh "
            "checkpoint_dir or remove the stale journal explicitly.")


class ShardJournalView:
    """One elastic lane's journal handle: WRITE to its own shard namespace,
    READ committed state across EVERY namespace of the job .

    Under elastic reassignment a chunk's durable shard can live in any
    lane's namespace — the lane that COMPUTED it (tagged ``owner`` in its
    manifest entry), which after a quarantine, a steal, or a resumed
    rebalanced job need not be the lane whose nominal span contains it.
    The walk's resume/skip logic (``committed`` / ``load_chunk`` /
    ``next_committed_lo`` / ``committed_crossing``) therefore consults the
    lane's own journal first, then every peer namespace, ADOPTING foreign
    commits instead of recomputing them — "resume replays only
    truly-uncommitted work".  Writes (``commit_chunk`` / ``mark_timeout``)
    go exclusively to the lane's own namespace, so the journal's
    single-writer-per-namespace protocol is untouched; a loaded entry is
    always rehydrated (and, on a torn shard, downgraded) by the journal
    that OWNS it, so its manifest bookkeeping stays correct.
    """

    def __init__(self, own: ChunkJournal, peers):
        self.own = own
        self.peers = [p for p in peers if p is not own]
        # lo -> journal holding the committed entry last returned for it;
        # load_chunk must dispatch to that journal (paths are
        # namespace-relative, and a torn-shard downgrade must hit the
        # owning manifest).  One view per lane; the rare concurrent writer
        # is a watchdog-abandoned worker re-probing the same lo, which
        # writes the same value.
        self._found_in: dict = {}

    def committed(self, lo: int):
        e = self.own.committed(lo)
        if e is not None:
            self._found_in[int(lo)] = self.own
            return e
        for j in self.peers:
            e = j.committed(lo)
            if e is not None:
                self._found_in[int(lo)] = j
                return e
        return None

    def load_chunk(self, entry: dict):
        j = self._found_in.get(int(entry["lo"]), self.own)
        return j.load_chunk(entry)

    def next_committed_lo(self, lo: int):
        cands = [j.next_committed_lo(lo) for j in (self.own, *self.peers)]
        cands = [c for c in cands if c is not None]
        return min(cands) if cands else None

    def committed_crossing(self, pos: int):
        for j in (self.own, *self.peers):
            x = j.committed_crossing(pos)
            if x is not None:
                return x
        return None

    def commit_chunk(self, *args, **kwargs):
        return self.own.commit_chunk(*args, **kwargs)

    def mark_timeout(self, *args, **kwargs):
        return self.own.mark_timeout(*args, **kwargs)


class MergeWarmer:
    """Overlap the sharded root-manifest merge with the last lanes' tails.

    A sharded walk's fast lanes finish (and atomically commit their shard
    manifests) while stragglers are still computing; the merge used to
    start only after EVERY lane joined, re-reading and re-parsing all the
    shard manifests on the critical path.  The warmer is a read-only
    background poller shard/process 0 runs while its lanes are still out:
    it watches each ``shard_?????/manifest.shard_?????.json``, parses any
    version it has not seen (keyed by ``(mtime_ns, size)`` — shard
    manifests are written by atomic replace, so a stat change IS a new
    complete version), and hands the cache to
    :func:`merge_job_manifest(cache=...)`, which re-reads only manifests
    that changed after their last warm parse.

    The single-writer rule is untouched: the warmer never writes anything
    — the root manifest is still written once, by the merge, after the
    barrier.  A parse failure is simply not cached (the merge re-reads
    and raises its own, properly attributed, error).
    """

    def __init__(self, directory: str, n_shards: int,
                 interval_s: float = 0.05):
        self.root = os.path.abspath(directory)
        self.paths = [
            os.path.join(self.root, f"shard_{sid:05d}",
                         f"manifest.shard_{sid:05d}.json")
            for sid in range(int(n_shards))]
        self.interval_s = float(interval_s)
        self._cache: dict = {}  # path -> ((mtime_ns, size), manifest)
        self._stop = threading.Event()
        self._worker = threading.Thread(
            target=self._run, daemon=True, name="merge-warmer")
        self._worker.start()

    def _poll_once(self) -> None:
        for path in self.paths:
            try:
                st = os.stat(path)
            except OSError:
                continue  # lane has not committed its manifest yet
            sig = (st.st_mtime_ns, st.st_size)
            hit = self._cache.get(path)
            if hit is not None and hit[0] == sig:
                continue
            try:
                with open(path, "rb") as f:
                    m = json.loads(f.read().decode())
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                continue  # merge will re-read and attribute the error
            self._cache[path] = (sig, m)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._poll_once()

    def stop(self) -> dict:
        """Stop polling and return the warm cache (one final sweep first,
        so lanes that committed in the last interval are still warm)."""
        self._stop.set()
        self._worker.join(timeout=30.0)
        self._poll_once()
        return self._cache


def merge_job_manifest(
    directory: str,
    *,
    config_hash: str,
    panel_fingerprint: str,
    n_rows: int,
    chunk_rows: int,
    spans,
    telemetry: Optional[dict] = None,
    extra: Optional[dict] = None,
    cache: Optional[dict] = None,
    rebalance: Optional[dict] = None,
) -> dict:
    """Fold the shard-namespace manifests of a sharded walk into the ONE
    job-level ``manifest.json`` at the journal root, and return the merged
    accounting.

    Called by shard/process 0 AFTER the lanes join — it is the only writer
    of the root manifest, mirroring the per-process single-writer rule.
    ``spans`` is the run's lane layout (``plan.shard_spans``); a shard
    manifest recorded under a different job (config hash, fingerprint,
    row count) or a different lane layout is STALE and raises rather than
    splicing foreign chunks into the job record.  Missing shard manifests
    are tolerated (a lane that crashed before its first commit, or another
    process's lane on a non-shared filesystem): their chunks simply stay
    pending, and a resume recomputes them.

    Merged chunk entries keep their npz shards where the lanes wrote them
    — the ``shard`` path is re-rooted relative to the journal root and
    each entry gains its ``shard_id`` — so the merged manifest itself
    satisfies the resume contract: the same sharded job resumes lane by
    lane from the shard namespaces, and a later SINGLE-device walk of the
    same (panel, config) can adopt the merged root manifest directly
    (plan knobs are excluded from the config hash; the chunk grid is
    shared by construction).

    ``cache`` (a :meth:`MergeWarmer.stop` result) short-circuits the read
    and parse of shard manifests whose ``(mtime_ns, size)`` signature is
    unchanged since the warmer saw them — the merge I/O then overlapped
    the last lanes' tails instead of following them.  Validation runs on
    the cached parse exactly as on a fresh read.

    **Elastic reconciliation**: a quarantined or stolen-from
    lane's chunks are committed by SURVIVORS into the survivors'
    namespaces, each entry tagged with its computing ``owner`` lane.  The
    merge reconciles by row range: per chunk ``lo`` a ``committed`` entry
    wins over a stale ``TIMEOUT``/pending duplicate from another
    namespace, every entry keeps its namespace-rooted npz path plus its
    ``owner`` tag, each ``shards[*]`` entry records its ``owner`` identity
    and how many of its committed chunks were reassigned in from other
    lanes' nominal spans, and the driver's quarantine/steal record lands
    as a top-level ``rebalance`` block (``tools/obs_report.py --check``
    validates all three; ``tools/advise_budget.py`` turns them into
    ``lane_retries``/``rebalance_threshold`` advice).
    """
    root = os.path.abspath(directory)
    # the root manifest is another job's write-ahead record until proven
    # otherwise: a sharded walk's lanes only ever open shard namespaces,
    # so the merge is the last line of defense — mirror ChunkJournal's
    # never-silently-overwrite contract (the driver also calls
    # check_root_manifest up front to fail BEFORE any compute)
    check_root_manifest(root, config_hash=config_hash,
                        panel_fingerprint=panel_fingerprint, n_rows=n_rows)
    spans = [(int(lo), int(hi)) for lo, hi in spans]
    shards, chunks = [], []
    run_id = None
    for sid, (slo, shi) in enumerate(spans):
        d = f"shard_{sid:05d}"
        mp = os.path.join(root, d, f"manifest.{d}.json")
        if not os.path.exists(mp):
            shards.append({"shard_id": sid, "lo": slo, "hi": shi,
                           "dir": d, "manifest": None, "run_id": None,
                           "chunks_committed": 0, "chunks_timeout": 0,
                           "resumes": 0})
            continue
        m = None
        if cache is not None:
            hit = cache.get(mp)
            if hit is not None:
                try:
                    st = os.stat(mp)
                    if (st.st_mtime_ns, st.st_size) == hit[0]:
                        m = hit[1]  # warm parse still current
                except OSError:
                    pass
        if m is None:
            try:
                with open(mp, "rb") as f:
                    m = json.loads(f.read().decode())
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                raise TornManifestError(
                    f"shard manifest {mp} does not parse ({e}); "
                    "inspect/remove the journal directory explicitly."
                ) from e
        mismatches = []
        if m.get("config_hash") != config_hash:
            mismatches.append("config_hash")
        if m.get("panel_fingerprint") != panel_fingerprint:
            mismatches.append("panel_fingerprint")
        if int(m.get("n_rows", -1)) != int(n_rows):
            mismatches.append("n_rows")
        mex = m.get("extra") or {}
        if (mex.get("shard_lo"), mex.get("shard_hi")) != (slo, shi) or \
                mex.get("n_shards") != len(spans):
            mismatches.append("shard layout")
        if mismatches:
            raise StaleJournalError(
                f"shard manifest {mp} belongs to a different job/layout "
                f"({', '.join(mismatches)} mismatch); remove the stale "
                "journal explicitly or use a fresh checkpoint_dir.")
        if run_id is None:
            run_id = m.get("run_id")
        entries = []
        for e in m.get("chunks", []):
            e2 = dict(e)
            e2["shard_id"] = sid
            if "shard" in e2:
                e2["shard"] = f"{d}/{e2['shard']}"
            entries.append(e2)
        chunks.extend(entries)
        shards.append({
            "shard_id": sid, "lo": slo, "hi": shi, "dir": d,
            "manifest": os.path.basename(mp), "run_id": m.get("run_id"),
            "chunks_committed": sum(1 for e in entries
                                    if e["status"] == "committed"),
            "chunks_timeout": sum(1 for e in entries
                                  if e["status"] == "TIMEOUT"),
            "resumes": len(m.get("resumes") or []),
        })
    # elastic reconciliation: one entry per chunk lo.  A chunk marked
    # TIMEOUT (or left pending) by one lane and later COMMITTED by another
    # must merge as committed — the committed shard is the durable truth,
    # and a duplicate entry would double-count its rows
    by_lo: dict = {}
    for e in chunks:
        cur = by_lo.get(e["lo"])
        if cur is None or (e["status"] == "committed"
                           and cur["status"] != "committed"):
            by_lo[e["lo"]] = e
    chunks = sorted(by_lo.values(), key=lambda e: e["lo"])
    # per-shard accounting is recomputed from the RECONCILED entries: a
    # TIMEOUT mark another lane later resolved as committed must not
    # linger in its namespace's totals (post-mortems and advise_budget
    # would report a timeout no chunk in the final result has).  Plus the
    # owner accounting: entries in this namespace whose rows fall OUTSIDE
    # its nominal span were reassigned in (a quarantine hand-off or a
    # steal) — a journaled fact read from the manifest alone
    for s in shards:
        sid, (slo, shi) = s["shard_id"], (s["lo"], s["hi"])
        mine = [e for e in chunks if e.get("shard_id") == sid]
        s["chunks_committed"] = sum(1 for e in mine
                                    if e["status"] == "committed")
        s["chunks_timeout"] = sum(1 for e in mine
                                  if e["status"] == "TIMEOUT")
        s["owner"] = sid
        s["chunks_reassigned_in"] = sum(
            1 for e in mine if e["status"] == "committed"
            and not (slo <= e["lo"] and e["hi"] <= shi))
    manifest = {
        "journal_version": JOURNAL_VERSION,
        "run_id": run_id or uuid.uuid4().hex[:12],  # lint: nondet(merge run identity metadata, never hashed)
        "created_at": time.time(),  # lint: nondet(manifest wall-clock metadata; never in fitted bytes)
        "updated_at": time.time(),  # lint: nondet(manifest wall-clock metadata; never in fitted bytes)
        "git_commit": _git_commit(),
        "config_hash": config_hash,
        "panel_fingerprint": panel_fingerprint,
        "n_rows": int(n_rows),
        "chunk_rows": int(chunk_rows),
        "process_index": 0,
        "merged_from_shards": len(spans),
        "extra": dict(extra or {}),
        "resumes": [],
        "chunks": chunks,
        "shards": shards,
    }
    if rebalance is not None:
        manifest["rebalance"] = {
            **rebalance,
            "reassigned_chunks": sum(s["chunks_reassigned_in"]
                                     for s in shards),
        }
    if telemetry is not None:
        manifest["telemetry"] = telemetry
    _atomic_write_bytes(
        os.path.join(root, MANIFEST),
        (json.dumps(manifest, indent=1, sort_keys=True) + "\n").encode())
    obs.event("journal.merged", shards=len(spans),
              chunks=len(chunks))
    return {
        "dir": root,
        "manifest": MANIFEST,
        "run_id": manifest["run_id"],
        "config_hash": config_hash,
        "process_index": 0,
        "merged_shards": len(spans),
        "chunks_committed": sum(s["chunks_committed"] for s in shards),
        "chunks_timeout": sum(s["chunks_timeout"] for s in shards),
        "shards": shards,
        **({"rebalance": manifest["rebalance"]}
           if rebalance is not None else {}),
    }



# ---------------------------------------------------------------------------
# lease records (fleet serving's single-writer election)
# ---------------------------------------------------------------------------
# A fleet of FitServer replicas shares ONE checkpoint root, but the root's
# durability story (write-ahead requests, batch journals, results) is a
# single-writer protocol — so exactly one replica may run a server at a
# time.  The lease is built from the primitives this module already
# guarantees:
#
# - **fencing tokens** are allocated by atomic claim manifests:
#   ``<root>/lease_claims/claim_<token>.json`` created with
#   ``O_CREAT | O_EXCL`` — the filesystem arbitrates, exactly one process
#   ever owns a token, and tokens are strictly monotonic (next = highest
#   existing + 1).  The HIGHEST claim is the lease holder.
# - **the lease record** ``<root>/lease.json`` is the holder's heartbeat,
#   written via :func:`durable_replace` (whole or absent, never torn).
#
# Liveness: a lease is LIVE while its highest claim is fresh — either the
# lease record's ``heartbeat_at`` or the claim file's mtime is within
# ``ttl_s``.  A SIGKILLed holder simply stops heartbeating; after ttl a
# standby claims token+1 and takes over.  A restarted zombie holding the
# OLD token fails :meth:`Lease.check` on its next write — stale-token
# writers lose loudly (:class:`FencedError`), they never splice bytes
# into the new holder's root.

LEASE_FILE = "lease.json"
LEASE_CLAIMS_DIR = "lease_claims"


def _lease_path(root: str) -> str:
    return os.path.join(root, LEASE_FILE)


def _claims_dir(root: str) -> str:
    return os.path.join(root, LEASE_CLAIMS_DIR)


def _claim_path(root: str, token: int) -> str:
    return os.path.join(_claims_dir(root), f"claim_{int(token):08d}.json")


def highest_claim(root: str) -> int:
    """The highest fencing token ever claimed under ``root`` (0 = none)."""
    top = 0
    try:
        for fn in os.listdir(_claims_dir(root)):
            if fn.startswith("claim_") and fn.endswith(".json"):
                try:
                    top = max(top, int(fn[len("claim_"):-len(".json")]))
                except ValueError:
                    pass
    except OSError:
        pass
    return top


def read_lease(root: str) -> Optional[dict]:
    """The current lease record, or None when absent/unreadable.

    ``lease.json`` is written via :func:`durable_replace`, so an
    unreadable record only happens under manual corruption — token
    monotonicity (and therefore fencing safety) rests on the claim
    manifests, never on this record, so unreadable degrades to None."""
    try:
        with open(_lease_path(root)) as f:
            rec = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return rec if isinstance(rec, dict) else None


def lease_is_live(root: str, *, now: Optional[float] = None) -> bool:
    """Whether SOME holder currently owns the root (highest claim fresh).

    The freshness source is the lease record's heartbeat when it carries
    the highest token, else the highest claim file's mtime (the window
    between a claim landing and its first heartbeat write)."""
    return _claim_is_live(root, highest_claim(root), now)


def _claim_is_live(root: str, top: int, now: Optional[float] = None) -> bool:
    """Whether claim ``top`` (the highest one a caller read) is live: the
    body of :func:`lease_is_live` for a top the caller has already read,
    so an election judges the same claim it then tries to follow."""
    if top == 0:
        return False
    now = time.time() if now is None else now  # lint: nondet(lease liveness is wall-clock by design; never fitted bytes)
    rec = read_lease(root)
    if rec is not None and int(rec.get("token", 0)) == top:
        if rec.get("released"):
            return False
        ttl = float(rec.get("ttl_s", 5.0))
        return (now - float(rec.get("heartbeat_at", 0.0))) < ttl
    # highest claimant has not heartbeated yet: fresh claim == live
    try:
        claim_path = _claim_path(root, top)
        with open(claim_path) as f:
            claim = json.load(f)
        ttl = float(claim.get("ttl_s", 5.0))
        return (now - os.stat(claim_path).st_mtime) < ttl
    except (OSError, json.JSONDecodeError, ValueError):
        return False


class Lease:
    """A held fleet lease: fencing token + heartbeat record.

    Instances come from :func:`acquire_lease`; holders call
    :meth:`heartbeat` at most every ``ttl_s / 3`` and :meth:`check`
    before every durable write they gate.  Both raise
    :class:`FencedError` the moment a higher claim exists — the holder
    must stop writing and step down.
    """

    def __init__(self, root: str, owner: str, token: int, ttl_s: float):
        self.root = os.path.abspath(root)
        self.owner = str(owner)
        self.token = int(token)
        self.ttl_s = float(ttl_s)

    def __repr__(self) -> str:
        return (f"Lease(root={self.root!r}, owner={self.owner!r}, "
                f"token={self.token}, ttl_s={self.ttl_s})")

    def check(self) -> None:
        """Raise :class:`FencedError` unless this token is still the
        highest claim — the gate every fenced write runs behind."""
        top = highest_claim(self.root)
        if top != self.token:
            raise FencedError(
                f"lease token {self.token} (owner {self.owner!r}) is "
                f"fenced: highest claim on {self.root} is {top} — "
                "stale-token writers must stop, not retry")

    def heartbeat(self) -> None:
        """Refresh the lease record's liveness (check first: a fenced
        holder must not resurrect its record over the new holder's)."""
        self.check()
        self._write_record()

    def release(self) -> None:
        """Mark the lease released so a successor acquires immediately
        instead of waiting out the ttl.  No-op once fenced."""
        try:
            self.check()
        except FencedError:
            return
        self._write_record(released=True)

    def _write_record(self, released: bool = False) -> None:
        rec = {
            "token": self.token,
            "owner": self.owner,
            "ttl_s": self.ttl_s,
            "heartbeat_at": time.time(),  # lint: nondet(lease liveness metadata; never fitted bytes)
            "released": bool(released),
        }
        _atomic_write_bytes(
            _lease_path(self.root),
            (json.dumps(rec, indent=1, sort_keys=True) + "\n").encode())


def acquire_lease(root: str, owner: str, *,
                  ttl_s: float = 5.0) -> Optional[Lease]:
    """Try to acquire the root's lease; None while another holder is live.

    The claim write is the election: an atomic hard link onto the next
    token's claim manifest means the filesystem picks exactly one winner
    per token, and a fresh claim counts as live (``lease_is_live``), so
    a racer that lost the claim sees the winner as the holder and backs
    off.  Callers poll — a standby loops ``acquire_lease`` until the
    incumbent's heartbeat goes stale.

    Each round reads the highest claim ONCE, judges that claim's liveness
    and links the next token after it.  Reading it twice (once to judge,
    once to choose the token) seats two winners: a racer that judged "no
    live holder" before another racer linked ``claim_1`` would then link
    ``claim_2`` and win too.  With one read it tries ``claim_1`` and
    loses on ``FileExistsError``."""
    root = os.path.abspath(root)
    os.makedirs(_claims_dir(root), exist_ok=True)
    for _ in range(64):
        top = highest_claim(root)
        if _claim_is_live(root, top):
            return None
        token = top + 1
        claim = {
            "token": token,
            "owner": str(owner),
            "ttl_s": float(ttl_s),
            "claimed_at": time.time(),  # lint: nondet(lease liveness metadata; never fitted bytes)
        }
        # the claim must be atomic AS WELL AS exclusive: a racer that
        # lost this token re-checks liveness immediately, and a claim
        # file it can see but not yet parse (created, bytes not landed)
        # would read as dead — letting it claim token+1 and seat TWO
        # winners.  So the bytes land in a hidden tmp first and a hard
        # link performs the election: the link either publishes a whole
        # claim or fails because someone else's whole claim is there.
        fd, tmp = tempfile.mkstemp(dir=_claims_dir(root),
                                   prefix=".tmp-claim-")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write((json.dumps(claim, indent=1, sort_keys=True)
                         + "\n").encode())
                f.flush()
                os.fsync(f.fileno())
            try:
                os.link(tmp, _claim_path(root, token))
            except FileExistsError:
                continue  # lost the election for this token; re-evaluate
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        lease = Lease(root, owner, token, ttl_s)
        lease._write_record()
        obs.event("lease.acquired", root=root, owner=str(owner),
                  token=token)
        return lease
    return None



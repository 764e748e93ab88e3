"""Panel augmentation: per-row side data packed into extra COLUMNS (port of
``forecasting/augment.py``).

The chunk driver (``reliability.fit_chunked``) slices exactly ONE panel and
hands each chunk to the fit function with no row coordinates.  Everything
a forecast (or warm-started refit) needs per row beyond the observations
therefore rides IN the panel: the augmented layout is

    ``[ y (n_time) | fitted params (k) | fit status (1) | row index (1) ]``

so a chunk of the augmented panel is self-describing — the forecast splits
it by static column offsets, the journal fingerprints it (fitted params
and statuses are part of the job identity: forecasting from different
params IS a different job), and every driver feature (pipelining,
prefetch, ``ChunkSource`` streaming) composes with zero new driver code.

:class:`ColumnBlockSource` is the streaming spelling: a horizontal
composition of column blocks — a (possibly column-sliced) inner
``ChunkSource`` plus host arrays — that reads rows on demand, so a panel
larger than the device is never materialized to build its augmented twin.
Its content fingerprint matches ``journal.panel_fingerprint`` of the
materialized augmented panel byte for byte, which is what makes
in-memory and source-streamed journals cross-resume.

The row-index column keys per-row sampling by the row's GLOBAL index, never
by chunk boundaries.  Indices are stored in the panel dtype — exact up to
2**24 rows at float32 (guarded loudly) and 2**53 at float64.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..reliability import source as source_mod
from ..reliability.status import FitStatus

__all__ = ["ColumnBlockSource", "augmented_panel", "augmented_host",
           "derive_status", "EXTRA_COLS"]

# status + row-index columns appended after the params block
EXTRA_COLS = 2

# largest exactly-representable consecutive integer per float dtype
_MAX_EXACT_ROWS = {np.dtype(np.float32): 1 << 24,
                   np.dtype(np.float64): 1 << 53}


def derive_status(params: np.ndarray, status=None) -> np.ndarray:
    """Per-row ``FitStatus`` for a bare params matrix: rows with any
    non-finite parameter are DIVERGED (a forecast must never turn NaN
    params into plausible numbers), the rest OK.  An explicit ``status``
    array passes through (validated for length)."""
    b = int(np.asarray(params).shape[0])
    if status is not None:
        st = np.asarray(status, np.int8)
        if st.shape != (b,):
            raise ValueError(
                f"status must be [{b}], got shape {st.shape}")
        return st
    finite = np.isfinite(np.asarray(params)).all(axis=-1)
    return np.where(finite, np.int8(FitStatus.OK),
                    np.int8(FitStatus.DIVERGED)).astype(np.int8)


class ColumnBlockSource(source_mod.ChunkSource):
    """Horizontal composition of column blocks over one row axis.

    ``blocks`` is a sequence of either host ``np.ndarray [B, w]`` blocks
    or ``(source, col_lo, col_hi)`` column windows of an inner
    :class:`~..reliability.source.ChunkSource` (``col_lo``/``col_hi``
    default to the full width).  All blocks share the row count and
    dtype.  Rows are read block-by-block into the caller's buffer; inner
    sources are read through a transient full-width scratch (bounded by
    the chunk size), so disk-backed panels stream without ever
    materializing.
    """

    kind = "columns"

    def __init__(self, blocks: Sequence, *,
                 pool: Optional[source_mod.StagingPool] = None):
        norm = []
        b = None
        dtype = None
        inner_defaults = []
        for blk in blocks:
            if isinstance(blk, tuple):
                src, lo, hi = blk
                lo = 0 if lo is None else int(lo)
                hi = int(src.shape[1]) if hi is None else int(hi)
                if not (0 <= lo < hi <= int(src.shape[1])):
                    raise source_mod.SourceError(
                        f"column window [{lo}, {hi}) outside source width "
                        f"{src.shape[1]}")
                rows, d = int(src.shape[0]), src.dtype
                if src.default_chunk_rows:
                    inner_defaults.append(int(src.default_chunk_rows))
                norm.append(("source", src, lo, hi))
                w = hi - lo
            elif isinstance(blk, source_mod.ChunkSource):
                rows, d = int(blk.shape[0]), blk.dtype
                if blk.default_chunk_rows:
                    inner_defaults.append(int(blk.default_chunk_rows))
                norm.append(("source", blk, 0, int(blk.shape[1])))
                w = int(blk.shape[1])
            else:
                arr = np.ascontiguousarray(blk)
                if arr.ndim != 2:
                    raise source_mod.SourceError(
                        f"host block must be 2-D, got shape {arr.shape}")
                rows, d = arr.shape[0], arr.dtype
                norm.append(("host", arr, 0, arr.shape[1]))
                w = arr.shape[1]
            if b is None:
                b, dtype = rows, np.dtype(d)
            elif rows != b:
                raise source_mod.SourceError(
                    f"column blocks disagree on rows: {rows} != {b}")
            elif np.dtype(d) != dtype:
                raise source_mod.SourceError(
                    f"column blocks disagree on dtype: {d} != {dtype}")
            del w
        if not norm:
            raise source_mod.SourceError("no column blocks")
        total_w = sum(hi - lo for _, _, lo, hi in norm)
        self.blocks = tuple(norm)
        import threading

        self._scratch = threading.local()
        super().__init__((b, total_w), dtype, pool=pool)
        if inner_defaults:
            self.default_chunk_rows = max(1, min(inner_defaults))
        else:
            row_bytes = max(1, total_w * self.dtype.itemsize)
            self.default_chunk_rows = max(
                1, min(b, source_mod._DEFAULT_SLICE_BYTES // row_bytes))

    def _scratch_for(self, idx: int, rows: int, cols: int, dtype):
        """Per-thread reusable scratch for inner-source reads: the walk
        (and its prefetcher, and every sharded lane) calls read_rows per
        chunk, and a fresh full-width allocation per call is pure churn.
        Thread-local so concurrent lane/prefetcher reads never share a
        buffer; grown monotonically to the largest chunk seen."""
        store = getattr(self._scratch, "bufs", None)
        if store is None:
            store = self._scratch.bufs = {}
        buf = store.get(idx)
        if buf is None or buf.shape[0] < rows:
            buf = store[idx] = np.empty((rows, cols), dtype)
        return buf[:rows]

    def read_rows(self, lo, hi, out):
        lo, hi = int(lo), int(hi)
        c = 0
        for i, (kind, blk, blo, bhi) in enumerate(self.blocks):
            w = bhi - blo
            if kind == "host":
                np.copyto(out[:, c:c + w], blk[lo:hi, blo:bhi])
            else:
                # the ChunkSource read contract is full-width rows; a
                # narrow column window still reads the whole row and
                # slices (API limitation, not allocation churn)
                scratch = self._scratch_for(i, hi - lo,
                                            int(blk.shape[1]), blk.dtype)
                blk.read_rows(lo, hi, scratch)
                np.copyto(out[:, c:c + w], scratch[:, blo:bhi])
            c += w

    def _nan_probe(self):
        nan_any = False
        for kind, blk, blo, bhi in self.blocks:
            if kind == "host":
                if np.isnan(blk[:, blo:bhi]).any():
                    nan_any = True
                    break
            else:
                # the inner probe covers the FULL width — conservative
                # (a NaN outside the window still reads as "any"), which
                # can only weaken the mode toward the always-correct one
                if blk._nan_probe()[0]:
                    nan_any = True
                    break
        kind, blk, blo, bhi = self.blocks[-1]
        if kind == "host":
            nan_last = bool(np.isnan(blk[:, bhi - 1]).any())
        else:
            nan_last = True  # conservative: no cheap last-col read
        return nan_any, nan_last

    def fingerprint(self) -> str:
        """Byte-identical to ``journal.panel_fingerprint`` of the
        materialized composite: the strided sample rows are read through
        the blocks, so an in-memory augmented walk and this streamed one
        journal under the SAME panel identity and cross-resume."""
        with self._mu:
            if self._fingerprint is not None:
                return self._fingerprint
        b, t = self.shape
        max_side = 256
        sr = max(1, -(-b // max_side))
        sc = max(1, -(-t // max_side))
        rows = range(0, b, sr)
        sample = np.empty((len(rows), len(range(0, t, sc))), self.dtype)
        buf = np.empty((1, t), self.dtype)
        for i, r in enumerate(rows):
            self.read_rows(r, r + 1, buf)
            sample[i] = buf[0, ::sc]
        h = hashlib.sha256()
        h.update(f"{b}x{t}:{sample.dtype}".encode())
        h.update(np.ascontiguousarray(sample).tobytes())
        fp = h.hexdigest()[:16]
        with self._mu:
            self._fingerprint = fp
        return fp


def augmented_host(y: np.ndarray, params: np.ndarray, status: np.ndarray,
                   *, base_row: int = 0) -> np.ndarray:
    """Host-materialized augmented panel (the serving path: request
    panels are host arrays already).  ``base_row`` offsets the row-index
    column (a server request's rows are locally indexed)."""
    y = np.ascontiguousarray(y)
    dtype = y.dtype
    b = y.shape[0]
    _check_row_index(base_row + b, dtype)
    cols = [y,
            np.ascontiguousarray(np.asarray(params, dtype)),
            np.asarray(status, np.int8).astype(dtype)[:, None],
            (base_row + np.arange(b, dtype=np.int64)).astype(dtype)[:, None]]
    return np.concatenate(cols, axis=1)


def augmented_panel(y, params: np.ndarray, status: np.ndarray):
    """The augmented panel in the input's own residency.

    A tensor ``y`` concatenates on its device (a numpy panel goes to the
    card first, as every entry point); a ``ChunkSource`` composes into a
    :class:`ColumnBlockSource` that
    streams ``y`` and serves the side columns from host RAM — byte
    positions identical either way, so the two spellings journal under
    one panel identity.  Returns ``(panel_or_source, n_time, k)``.
    """
    params = np.asarray(params)
    if params.ndim != 2:
        raise ValueError(f"params must be [rows, k], got {params.shape}")
    status = np.asarray(status, np.int8)
    if isinstance(y, source_mod.ChunkSource):
        b, t = (int(y.shape[0]), int(y.shape[1]))
        dtype = np.dtype(y.dtype)
        if params.shape[0] != b:
            raise ValueError(
                f"params rows {params.shape[0]} != panel rows {b}")
        _check_row_index(b, dtype)
        side = np.concatenate(
            [np.ascontiguousarray(params.astype(dtype)),
             status.astype(dtype)[:, None],
             np.arange(b, dtype=np.int64).astype(dtype)[:, None]], axis=1)
        return (ColumnBlockSource([(y, 0, t), side]),
                t, int(params.shape[1]))
    from ..models.base import to_device

    yb = y if isinstance(y, torch.Tensor) else to_device(y, "cuda")
    if yb.ndim != 2:
        raise ValueError(f"expected [batch, time], got {tuple(yb.shape)}")
    if params.shape[0] != yb.shape[0]:
        raise ValueError(
            f"params rows {params.shape[0]} != panel rows {yb.shape[0]}")
    dtype = np.dtype(str(yb.dtype).replace("torch.", ""))
    _check_row_index(int(yb.shape[0]), dtype)
    side = np.concatenate(
        [np.ascontiguousarray(params.astype(dtype)),
         status.astype(dtype)[:, None],
         np.arange(int(yb.shape[0]), dtype=np.int64).astype(dtype)[:, None]],
        axis=1)
    aug = torch.cat([yb, torch.as_tensor(side, device=yb.device)], dim=1)
    return aug, int(yb.shape[1]), int(params.shape[1])


def _check_row_index(n_rows: int, dtype: np.dtype) -> None:
    limit = _MAX_EXACT_ROWS.get(np.dtype(dtype))
    if limit is None:
        raise ValueError(f"unsupported panel dtype {dtype} for forecasting")
    if n_rows > limit:
        raise ValueError(
            f"{n_rows} rows exceed the exactly-representable row-index "
            f"range of {dtype} ({limit}); use float64 panels beyond that")

"""Micro-batching: pack compatible tenant panels into ONE chunked walk
(port of ``serving/batcher.py``).

The serving workload is many small panels (a tenant's dozens-to-thousands
of series), and dispatching each alone wastes the device the same way
separate per-order walks of an order search would: launch overhead and
underfull kernels dominate.  The batcher is the order-axis packing idea
applied to TENANTS — requests sharing a batch key (model, panel width,
dtype, fit kwargs, align mode, resilience knobs, deadline-ness) are
concatenated row-wise into one panel, walked once through
``reliability.fit_chunked``, and demuxed back per request.

**The cell grid is what makes batching bitwise-safe.**  Per-row results
of the bundled fits are independent BETWEEN chunks but carry low-order
bits of their chunk's SHAPE within one (the lockstep batched L-BFGS and
its straggler compaction see the whole chunk, on both of the port's
backends), so naive concatenation
would make a tenant's numbers depend on who it was batched with.  The
batcher therefore quantizes: every request is padded (repeating its last
row; pad rows dropped at demux) to a multiple of the server's
``cell_rows``, the packed walk runs at ``chunk_rows == cell_rows``, and
every chunk thus holds rows of exactly ONE request with
position-identical bytes whether the request rides a big batch or goes
solo — the demuxed slice is bitwise-identical to the same request
submitted alone (and to a direct ``fit_chunked(chunk_rows=cell_rows)``
walk whenever the request's row count is already a cell multiple), the
property ``tests/test_serving.py`` pins.  The key includes the
per-request align mode (computed host-side at admission) because the
align plan selects the fit's code path: same-mode panels concatenate to
the same mode, so the hint the batch walk runs under is exactly the hint
each solo walk would run under.

A batch's membership is DURABLE before its walk starts
(:meth:`MicroBatch.save_members`): the batch id is a deterministic hash of
the member request ids, the walk journals under
``<root>/batches/<batch_id>/journal``, and a SIGKILLed server re-forms the
batch from its members record on restart — the journal then resumes
bitwise, replaying only uncommitted chunks.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Optional, Sequence

import numpy as np

from ..reliability.status import STATUS_DTYPE, FitStatus, status_counts
from .session import FitRequest, TenantFitResult

__all__ = ["MicroBatch", "batch_key", "pack", "timeout_result"]

MEMBERS_FILE = "members.json"
COMPLETE_FILE = "COMPLETE"


def batch_key(req: FitRequest) -> tuple:
    """Requests coalesce iff their keys are equal.

    Everything that selects the fit's code path or changes per-row
    semantics is in the key; the tenant, priority, and row count are not
    (those are what batching is supposed to mix).  Deadline-BEARING
    requests only coalesce with other deadline-bearing ones: a batch's
    job budget is the earliest member deadline, and budgetless requests
    must never inherit someone else's clock.
    """
    model = req.model if isinstance(req.model, str) else repr(req.model)
    return (
        model,
        int(req.values.shape[1]),
        str(req.values.dtype),
        json.dumps(req.fit_kwargs, sort_keys=True, default=repr),
        req.align_mode,
        req.resilient,
        req.policy,
        req.deadline_s is not None,
    )


class MicroBatch:
    """An ordered bundle of requests packed onto one cell-quantized panel.

    Each member occupies ``ceil(rows / cell_rows)`` whole cells starting
    at a cell boundary (short members padded by repeating their last
    row); ``spans`` are the members' REAL row spans inside the padded
    panel, and :meth:`demux` drops the pad rows.  The walk must run at
    ``chunk_rows == cell_rows`` so chunk bytes per request are
    position-identical across batch compositions (module docstring).
    """

    __slots__ = ("members", "spans", "values", "batch_id", "seq",
                 "cell_rows", "pad_rows")

    def __init__(self, members: Sequence[FitRequest], seq: int,
                 cell_rows: int = 1):
        if not members:
            raise ValueError("a micro-batch needs at least one request")
        self.members: List[FitRequest] = list(members)
        self.seq = int(seq)
        self.cell_rows = max(1, int(cell_rows))
        cell = self.cell_rows
        spans, parts, lo, pad_total = [], [], 0, 0
        for r in self.members:
            spans.append((lo, lo + r.rows))
            parts.append(np.asarray(r.values))
            pad = (-r.rows) % cell
            if pad:
                parts.append(np.repeat(np.asarray(r.values)[-1:], pad,
                                       axis=0))
            lo += r.rows + pad
            pad_total += pad
        self.spans = spans
        self.pad_rows = pad_total
        self.values = (np.ascontiguousarray(parts[0]) if len(parts) == 1
                       else np.concatenate(parts))
        # deterministic identity: the same membership (the unit recovery
        # replays) names the same journal directory on every process
        h = hashlib.sha256(
            "\n".join(m.req_id for m in self.members).encode())
        self.batch_id = f"b{h.hexdigest()[:16]}"

    @property
    def rows(self) -> int:
        return int(self.values.shape[0])

    @property
    def payload_rows(self) -> int:
        """Real (unpadded) rows across members."""
        return self.rows - self.pad_rows

    @property
    def tenants(self) -> tuple:
        return tuple(dict.fromkeys(m.tenant for m in self.members))

    def job_budget_s(self) -> Optional[float]:
        """The batch walk's wall budget: the earliest member deadline
        still outstanding (None when no member carries one — the batch
        key keeps the two populations apart)."""
        rems = [m.remaining_s() for m in self.members
                if m.deadline_s is not None]
        rems = [r for r in rems if r is not None]
        if not rems:
            return None
        return max(0.0, min(rems))

    # -- durable membership record -------------------------------------------

    def dir(self, root: str) -> str:
        return os.path.join(root, "batches", self.batch_id)

    def save_members(self, root: str, knobs: dict) -> str:
        """Write the membership + walk knobs record (atomic) BEFORE the
        walk: restart recovery re-forms exactly this batch with exactly
        these knobs, so the journal's config hash matches and committed
        chunks replay instead of recomputing."""
        d = self.dir(root)
        os.makedirs(d, exist_ok=True)
        rec = {
            "batch_id": self.batch_id,
            "seq": self.seq,
            "cell_rows": self.cell_rows,
            "members": [{"req_id": m.req_id, "tenant": m.tenant,
                         "rows": m.rows} for m in self.members],
            "knobs": knobs,
        }
        path = os.path.join(d, MEMBERS_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    def mark_complete(self, root: str) -> None:
        """Every member's result is durable: the batch never re-runs."""
        path = os.path.join(self.dir(root), COMPLETE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("complete\n")
        os.replace(tmp, path)

    # -- demux ---------------------------------------------------------------

    def demux(self, res) -> List[TenantFitResult]:
        """Slice a ``ResilientFitResult`` of the packed panel back into
        per-request results (copies: a request's arrays must not pin the
        whole batch panel alive in the server)."""
        out = []
        batch_meta = {
            "batch_id": self.batch_id,
            "batch_rows": self.rows,
            "batch_members": len(self.members),
            "chunk_rows_final": res.meta.get("chunk_rows_final"),
            "degraded": res.meta.get("degraded", False),
        }
        if "journal" in res.meta:
            batch_meta["journal"] = {
                k: res.meta["journal"].get(k)
                for k in ("dir", "run_id", "chunks_committed",
                          "chunks_resumed", "chunks_timeout")}
        for m, (lo, hi) in zip(self.members, self.spans):
            status = np.array(res.status[lo:hi])
            out.append(TenantFitResult(
                params=np.array(res.params[lo:hi]),
                neg_log_likelihood=np.array(res.neg_log_likelihood[lo:hi]),
                converged=np.array(res.converged[lo:hi]),
                iters=np.array(res.iters[lo:hi]),
                status=status,
                meta={**batch_meta, "req_id": m.req_id, "tenant": m.tenant,
                      "status_counts": status_counts(status)},
            ))
        return out


def pack(members: Sequence[FitRequest], seq: int,
         cell_rows: int = 1) -> MicroBatch:
    """Build a :class:`MicroBatch` (members must share a batch key —
    the admission queue's ``take_batch`` guarantees it)."""
    return MicroBatch(members, seq, cell_rows)


def timeout_result(req: FitRequest, reason: str) -> TenantFitResult:
    """An all-TIMEOUT answer for a request whose deadline expired before
    its batch dispatched — the serving twin of the chunk driver's
    undispatched-chunk TIMEOUT marks (params NaN, status TIMEOUT, never a
    hang).  ``k`` degenerates to one NaN column exactly like an
    all-TIMEOUT walk."""
    n = req.rows
    dtype = req.values.dtype
    status = np.full(n, FitStatus.TIMEOUT, STATUS_DTYPE)
    return TenantFitResult(
        params=np.full((n, 1), np.nan, dtype),
        neg_log_likelihood=np.full(n, np.nan, dtype),
        converged=np.zeros(n, bool),
        iters=np.zeros(n, np.int32),
        status=status,
        meta={"req_id": req.req_id, "tenant": req.tenant,
              "deadline_expired": True, "reason": reason,
              "status_counts": status_counts(status)},
    )

"""Common model interface (port of ``models/base.py``).

- Every model module exposes ``fit(y, ...) -> FitResult`` accepting
  ``[time]`` or ``[batch, time]``.
- ``FitResult.params`` is ``[batch?, k]``; per-series diagnostics ride
  along, with per-row :class:`~..reliability.FitStatus` codes.
- Entry points take ``device`` (default ``"cuda"``) and move numpy or CPU
  input there; the CPU is used only when the caller asks for it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..reliability.status import FitStatus

BACKENDS = ("auto", "eager", "cuda")


def to_device(y, device="cuda", dtype=None) -> torch.Tensor:
    """``y`` (numpy, list or tensor) as a tensor on ``device``.

    ``device="cuda"`` with no card raises: an entry point never quietly
    runs on the CPU.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the host")
    if isinstance(y, torch.Tensor):
        return y.to(device=device, dtype=dtype or y.dtype)
    arr = np.asarray(y)
    if dtype is None and arr.dtype.kind != "f":
        arr = arr.astype(np.float32)
    if not arr.flags.writeable:  # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.as_tensor(arr, dtype=dtype, device=device)


def as_generator(gen, device) -> torch.Generator:
    """A simulation's random source: a ``torch.Generator`` as given, or a
    new one on ``device`` seeded with the integer ``gen``."""
    if isinstance(gen, torch.Generator):
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(int(gen))
    return g


def resolve_backend(backend: str, y: torch.Tensor,
                    structural_ok: bool = True) -> str:
    """Validate a fit ``backend`` and resolve ``"auto"``.

    ``"cuda"`` runs the hand-written kernels (``ops.cuda_kernels``) and
    needs a float32 CUDA tensor; ``"eager"`` runs plain PyTorch on any
    device and dtype.  ``"auto"`` picks ``"cuda"`` for a float32 CUDA
    tensor whose model structure fits the kernels (``structural_ok``, e.g.
    ``cuda_kernels.css_structural_ok(p, q)``), else ``"eager"``.  Dispatch
    is by structure only: nothing falls back because a kernel failed.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (one of {BACKENDS})")
    from ..ops import cuda_kernels as ck

    if backend == "cuda":
        if not ck.supported(y):
            raise ValueError(
                "backend='cuda' needs a float32 tensor on a CUDA device "
                f"(got {y.dtype} on {y.device})")
        return backend
    if backend == "eager":
        return backend
    return "cuda" if structural_ok and ck.supported(y) else "eager"


class FitResult(NamedTuple):
    """Batched fit output: parameters + convergence diagnostics.

    ``status`` carries per-row ``FitStatus`` codes (int8): ``OK``
    (converged, finite params), ``DIVERGED`` (optimizer failed or produced
    non-finite output) or ``EXCLUDED`` (rejected structurally).
    """

    params: torch.Tensor  # [batch?, k]
    neg_log_likelihood: torch.Tensor  # [batch?]
    converged: torch.Tensor  # [batch?] bool
    iters: torch.Tensor  # [batch?] int32
    status: Optional[torch.Tensor] = None  # [batch?] int8


def derive_status(ok, converged, params) -> torch.Tensor:
    """Per-row FitStatus of a plain fit: gated-out rows are ``EXCLUDED``,
    rows converged to finite params ``OK``, everything else ``DIVERGED``."""
    good = ok & converged & torch.isfinite(params).all(-1)
    code = lambda s: torch.tensor(int(s), dtype=torch.int8,  # noqa: E731
                                  device=params.device)
    return torch.where(~ok, code(FitStatus.EXCLUDED),
                       torch.where(good, code(FitStatus.OK),
                                   code(FitStatus.DIVERGED)))


def ensure_batched(y: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Promote ``[time]`` to ``[1, time]``; report whether input was single."""
    if y.ndim == 1:
        return y[None, :], True
    if y.ndim == 2:
        return y, False
    raise ValueError(f"series must be [time] or [batch, time], got "
                     f"{tuple(y.shape)}")


def debatch(x, single: bool):
    """Drop the batch axis of one ``[time]`` series' result: a tensor, or
    each field of a named tuple such as :class:`FitResult` (``None``
    fields stay ``None``)."""
    if not single:
        return x
    if isinstance(x, torch.Tensor):
        return x[0]
    return type(x)(*(None if a is None else a[0] for a in x))


def require_pallas_for_count_evals(count_evals: bool, backend: str) -> None:
    """The ``count_evals`` contract (the reference's name): pass accounting
    instruments the batched L-BFGS (``utils.optim``).  The reference runs
    it only on its pallas backends; both of the port's resolved backends,
    ``"eager"`` and ``"cuda"``, run it, so either is accepted and only a
    backend that is not one of them is refused."""
    if count_evals and backend not in ("eager", "cuda"):
        raise ValueError("count_evals requires a resolved fit backend, "
                         f"'eager' or 'cuda' (got {backend!r})")


def debatch_fit(out, single: bool, count_evals: bool):
    """Unpack a fit's ``result | (result, info)`` return shape."""
    if count_evals:
        res, info = out
        return debatch(res, single), info
    return debatch(out, single)


ALIGN_MODES = ("dense", "no-trailing", "general")


def resolve_align_mode(yb, align_mode: Optional[str] = None) -> str:
    """A fit's alignment mode: caller hint or host probe.

    ``None`` probes the panel (:func:`align_mode_on_host`, one host read).
    **Hint contract**: an unknown name raises ``ValueError``; a weaker mode
    than the data needs is correct, only slower; a STRONGER one surfaces per
    row — under ``"dense"`` any NaN poisons that row's objective
    (``DIVERGED``), under ``"no-trailing"`` a row whose last position is
    NaN is excluded (``n_valid=0``, NaN params, ``EXCLUDED``) by
    :func:`maybe_align` — never silently wrong estimates.
    """
    if align_mode is None:
        return align_mode_on_host(yb)
    if align_mode not in ALIGN_MODES:
        raise ValueError(
            f"unknown align_mode {align_mode!r} (one of {ALIGN_MODES})")
    return align_mode


def align_mode_on_host(yb: torch.Tensor) -> str:
    """How much per-row alignment this panel needs: ``"dense"`` (no NaN),
    ``"no-trailing"`` (every row valid at the last position: prefix zeroing
    only) or ``"general"`` (trailing NaNs: the full per-row roll).  One
    fused reduction and one host read."""
    nan = torch.isnan(yb)
    flags = torch.stack([nan.any(), nan[:, -1].any()]).cpu()
    if not bool(flags[0]):
        return "dense"
    return "general" if bool(flags[1]) else "no-trailing"


def maybe_align(yb: torch.Tensor, mode: str):
    """``(aligned, n_valid int32 [B])`` under an :func:`align_mode_on_host`
    mode."""
    b, t = yb.shape
    if mode == "dense":
        return yb, torch.full((b,), t, dtype=torch.int32, device=yb.device)
    if mode == "no-trailing":
        valid = ~torch.isnan(yb)
        first = valid.to(torch.int8).argmax(1)
        nv = t - first
        ti = torch.arange(t, device=yb.device)[None, :]
        ya = torch.where(ti >= first[:, None], torch.nan_to_num(yb), 0.0)
        # hint guard: a row whose LAST position is NaN violates the hint —
        # exclude it instead of fitting a zero-filled tail
        bad = torch.isnan(yb[:, -1])
        ya = torch.where(bad[:, None], torch.nan, ya)
        nv = torch.where(bad, 0, nv)
        return ya, nv.to(torch.int32)
    return align_right(yb)


def align_right(y: torch.Tensor):
    """Shift each row's valid span to END at the last position ->
    ``(y', n_valid)``; works on ``[T]`` or ``[B, T]``.

    The valid run ``[first_non_nan, last_non_nan]`` is rolled to end at
    ``T-1``, padding positions become 0.0, interior NaNs become 0.0, and an
    all-NaN row gets ``n_valid=0``.
    """
    single = y.ndim == 1
    yb = y[None] if single else y
    b, t = yb.shape
    valid = ~torch.isnan(yb)
    any_valid = valid.any(1)
    first = valid.to(torch.int8).argmax(1)
    last = t - 1 - valid.flip(1).to(torch.int8).argmax(1)
    nv = torch.where(any_valid, last - first + 1, 0)
    shift = (t - 1) - last
    ti = torch.arange(t, device=yb.device)[None, :]
    src = (ti - shift[:, None]) % t  # roll right by shift
    rolled = torch.gather(yb, 1, src)
    rolled = torch.where(ti >= (t - nv)[:, None], rolled, 0.0)
    out, nv = torch.nan_to_num(rolled), nv.to(torch.int32)
    return (out[0], nv[0]) if single else (out, nv)

"""The kernels' panel layout: time-major ``[T, B]`` float32.

The CUDA kernels (``ops.cuda_kernels``) run one thread per series walking
time, so the panel is stored time-major: at each step the 32 threads of a
warp read 32 neighbouring floats.  A fit converts its panel ONCE
(:func:`css_prefold`); the init sweeps and every optimizer evaluation then
read the same tensor.  (The reference folds to ``[T, B/128, 128]`` and
chunks time by 1024 for the TPU's vector registers and VMEM; that tiling
has no counterpart here.  Its semantics do: the ``zb`` mask, ``t_limit``
and an unbounded ``T``.)

:class:`FoldedPanel` is the resident form of a panel for the transforms
(the reference's ``ops.layout.FoldedPanel``): converted once at ingest with
:func:`fold_panel`, it passes through the fill chain and the
autocorrelation kernels with no further layout conversion.
"""

from __future__ import annotations

import torch

__all__ = ["time_major", "css_prefold", "FoldedPanel", "fold_panel",
           "unfold_panel"]


def time_major(x: torch.Tensor) -> torch.Tensor:
    """``[B, T] -> [T, B]``: a fresh contiguous copy, never a view of ``x``
    (callers may edit it in place)."""
    return x.t().clone(memory_format=torch.contiguous_format)


def css_prefold(yd: torch.Tensor, order, n_valid=None):
    """Convert a differenced panel ``[B, T]`` into the CSS kernels' layout
    -> ``(yt, zb)``.

    ``yt`` is the time-major ``[T, B]`` copy with each row's invalid prefix
    (positions before ``start = T - n_valid``) zeroed, so lags that reach
    below the start read the zeros a trimmed series would see; ``zb`` is
    ``start + p`` (float, ``[B]``): errors before it are conditioned out.
    """
    p = order[0]
    b, n = yd.shape
    nv = (torch.full((b,), n, dtype=yd.dtype, device=yd.device)
          if n_valid is None else n_valid.to(yd.dtype))
    start = n - nv
    yt = time_major(yd)
    t_idx = torch.arange(n, dtype=yd.dtype, device=yd.device)
    yt.masked_fill_(t_idx[:, None] < start[None, :], 0.0)  # yt is a copy
    return yt, start + p


class FoldedPanel:
    """A ``[B, T]`` panel resident in the kernels' layout: ``data`` is the
    contiguous time-major ``[T, B]`` tensor; ``b`` and ``t`` are the
    natural sizes (no padding on either axis)."""

    __slots__ = ("data", "b", "t")

    def __init__(self, data: torch.Tensor, b: int, t: int):
        if tuple(data.shape) != (int(t), int(b)):
            raise ValueError(f"folded data must be [t, b] = [{t}, {b}], got "
                             f"{tuple(data.shape)}")
        self.data = data
        self.b = int(b)
        self.t = int(t)

    @property
    def shape(self):  # natural-layout shape, for duck-typed shape checks
        return (self.b, self.t)

    @property
    def dtype(self):
        return self.data.dtype

    def __repr__(self):
        return (f"FoldedPanel(b={self.b}, t={self.t}, "
                f"data={tuple(self.data.shape)} {self.data.dtype})")


def fold_panel(y: torch.Tensor) -> FoldedPanel:
    """``[B, T] -> FoldedPanel``: one transposing copy, amortized over every
    later kernel dispatch on the panel."""
    b, t = y.shape
    return FoldedPanel(time_major(y), b, t)


def unfold_panel(fp: FoldedPanel) -> torch.Tensor:
    """``FoldedPanel -> [B, T]`` natural layout (one transposing copy)."""
    return time_major(fp.data)

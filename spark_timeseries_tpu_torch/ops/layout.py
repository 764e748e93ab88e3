"""The kernels' panel layout: time-major ``[T, B]`` float32.

The CUDA kernels (``ops.cuda_kernels``) run one thread per series walking
time, so the panel is stored time-major: at each step the 32 threads of a
warp read 32 neighbouring floats.  A fit converts its panel ONCE
(:func:`css_prefold`); the init sweeps and every optimizer evaluation then
read the same tensor.  (The reference folds to ``[T, B/128, 128]`` and
chunks time by 1024 for the TPU's vector registers and VMEM; that tiling
has no counterpart here.  Its semantics do: the ``zb`` mask, ``t_limit``
and an unbounded ``T``.)
"""

from __future__ import annotations

import torch

__all__ = ["time_major", "css_prefold"]


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

"""Panel layout and the hand-written CUDA kernels."""

from . import cuda_kernels, layout

__all__ = ["cuda_kernels", "layout"]

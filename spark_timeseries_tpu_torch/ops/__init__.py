"""Panel layout, the per-series transforms and the hand-written CUDA
kernels."""

from . import cuda_kernels, lagmat, layout, univariate

__all__ = ["cuda_kernels", "lagmat", "layout", "univariate"]

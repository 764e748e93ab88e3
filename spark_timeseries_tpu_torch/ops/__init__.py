"""Panel layout, the per-series transforms and the hand-written CUDA
kernels."""

from . import cuda_kernels, lagmat, layout, univariate
from .lagmat import lag_mat_trim_both, lag_mat_trim_both_2d
from .layout import FoldedPanel, fold_panel, unfold_panel

__all__ = [
    "cuda_kernels",
    "lagmat",
    "layout",
    "univariate",
    "lag_mat_trim_both",
    "lag_mat_trim_both_2d",
    "FoldedPanel",
    "fold_panel",
    "unfold_panel",
]

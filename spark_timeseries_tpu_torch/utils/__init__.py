"""Batched optimizer, small linear algebra and the kernel-library cache
accounting."""

from . import compile_cache, linalg, optim
from .optim import batched_minimize, minimize_lbfgs

__all__ = ["compile_cache", "linalg", "optim", "minimize_lbfgs",
           "batched_minimize"]

"""Batched optimizer, small linear algebra and the kernel-library cache
accounting."""

from . import compile_cache, linalg, optim

__all__ = ["compile_cache", "linalg", "optim"]

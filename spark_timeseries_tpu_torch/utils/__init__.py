"""Batched optimizer and small linear algebra."""

from . import linalg, optim

__all__ = ["linalg", "optim"]

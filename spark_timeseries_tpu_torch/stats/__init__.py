"""Statistical hypothesis tests (port of ``stats``)."""

from . import tests
from .tests import adftest, bgtest, bptest, dwtest, kpsstest, lbtest

__all__ = ["tests", "adftest", "dwtest", "bgtest", "bptest", "lbtest",
           "kpsstest"]

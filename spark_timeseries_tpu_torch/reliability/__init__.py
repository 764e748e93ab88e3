"""Per-row fit status vocabulary (the port's ``reliability`` subset)."""

from .status import STATUS_DTYPE, FitStatus, merge_status, status_counts

__all__ = ["FitStatus", "STATUS_DTYPE", "status_counts", "merge_status"]

"""Panel-scale forecasting (port of ``forecasting/``): so far its panel
augmentation, which the delta walk's warm start shares
(:mod:`.augment`).  The forecast walk itself is not ported yet."""

from . import augment
from .augment import (ColumnBlockSource, augmented_host, augmented_panel,
                      derive_status)

__all__ = [
    "ColumnBlockSource",
    "augment",
    "augmented_host",
    "augmented_panel",
    "derive_status",
]

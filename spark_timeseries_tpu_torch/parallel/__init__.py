"""Device meshes (port of ``parallel/``): see :mod:`.mesh`."""

from . import mesh
from .mesh import (
    SERIES_AXIS,
    TIME_AXIS,
    default_mesh,
    instant_sharding,
    replicated_sharding,
    series_sharding,
)

__all__ = [
    "mesh",
    "SERIES_AXIS",
    "TIME_AXIS",
    "default_mesh",
    "series_sharding",
    "replicated_sharding",
    "instant_sharding",
]

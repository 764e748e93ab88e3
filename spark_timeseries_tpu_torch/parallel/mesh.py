"""Device meshes and row placement (port of ``parallel/mesh.py``).

The reference places a panel's ``[keys, time]`` array on a
``jax.sharding.Mesh`` with a ``"series"`` axis (and, for very long series,
a ``"time"`` axis) and lets XLA partition one program across it.  PyTorch
has no global sharded array, so here a :class:`Mesh` is a numpy object
array of ``torch.device`` cells with axis names, and a mesh-attached panel
keeps ONE tensor on the mesh's first cell device; the time-sharded
functions of :mod:`..ops.seqparallel` split it into per-cell blocks, each
on its cell's device, and hand carries between blocks with ``.to()``.

A mesh may list one device several times: those are virtual shards of one
card (the analog of the reference tests' forced 8-device CPU mesh, which
torch cannot make).  The sharding helpers return :class:`NamedSharding`
descriptions, a ``(mesh, spec)`` pair, in place of JAX's placements.

This module is the single-process half of the reference's: the
multi-process placement (``jax.distributed``) belongs to the multi-lane
chunk walk, which is not ported yet; :func:`init_distributed` with an
explicit topology and :func:`distribute_panel` under a multi-process
group raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

SERIES_AXIS = "series"
TIME_AXIS = "time"

_MULTI_PROCESS = ("a multi-process mesh belongs to the multi-lane chunk "
                  "walk, which is not ported yet: ROADMAP queue 1, item "
                  "17's second half")


class PartitionSpec(tuple):
    """Per-dimension mesh axis names (``None``: not split), as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


class Mesh:
    """A grid of ``torch.device`` cells with named axes.

    ``devices`` is the numpy object array of devices (one axis per name),
    ``axis_names`` the names and ``shape`` the ``{axis: size}`` mapping, as
    on ``jax.sharding.Mesh``.  A device may appear in several cells.
    """

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        for i, d in enumerate(arr.flat):
            arr.flat[i] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} needs one name "
                             f"per axis and a device, got {axis_names}")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class NamedSharding:
    """Where a ``[keys, time]`` array goes on ``mesh``: ``spec`` names the
    mesh axis each dimension is split over."""

    mesh: Mesh
    spec: PartitionSpec


def _visible_cuda_devices() -> list:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available for a default mesh; pass "
            "devices= (e.g. [torch.device('cpu')] * 4) to build one "
            "elsewhere")
    return [torch.device("cuda", i) for i in range(n)]


def default_mesh(
    n_devices: Optional[int] = None,
    *,
    time_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a mesh over the visible CUDA devices (or ``devices``).

    1-D ``(series,)`` by default; pass ``time_shards > 1`` for a 2-D
    ``(series, time)`` mesh used by the time-sharded functions.  Without
    a card, ``devices=`` is required (a device may be listed more than
    once: virtual shards of one device).
    """
    devs = (list(devices) if devices is not None
            else _visible_cuda_devices())
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    arr = np.array(devs, dtype=object)
    if time_shards > 1:
        if n % time_shards:
            raise ValueError(
                f"{n} devices not divisible by time_shards={time_shards}")
        return Mesh(arr.reshape(n // time_shards, time_shards),
                    (SERIES_AXIS, TIME_AXIS))
    return Mesh(arr, (SERIES_AXIS,))


def series_sharding(mesh: Mesh) -> NamedSharding:
    """``[keys, time]`` split over keys, time replicated (or time-split on
    a 2-D mesh)."""
    if TIME_AXIS in mesh.axis_names:
        return NamedSharding(mesh, PartitionSpec(SERIES_AXIS, TIME_AXIS))
    return NamedSharding(mesh, PartitionSpec(SERIES_AXIS, None))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Fully replicated: the broadcast-index analog."""
    return NamedSharding(mesh, PartitionSpec())


def instant_sharding(mesh: Mesh) -> NamedSharding:
    """``[time, keys]`` split over time: the layout of the ``to_instants``
    transpose."""
    return NamedSharding(mesh, PartitionSpec(SERIES_AXIS, None))


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m


def _first_device(mesh: Mesh) -> torch.device:
    return mesh.devices.flat[0]


def shard_series(values: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Place a ``[keys, time]`` tensor for ``mesh``: on the mesh's first
    cell device (no copy when it is there already), where the time-sharded
    functions split it into cell blocks.  The keys axis must already be
    padded to a multiple of the mesh's series size (``TimeSeriesPanel``
    pads with NaN rows at construction)."""
    if mesh is None:
        return values
    from .. import obs

    with obs.span("mesh.shard_series", keys=int(values.shape[0]),
                  devices=mesh.size):
        return values.to(_first_device(mesh))


def series_devices(mesh: Mesh) -> list:
    """The devices along the series axis, in shard order: the lane owners
    of a sharded chunk walk (one lane per entry).  A 2-D mesh with more
    than one time shard is rejected: its time axis belongs to the
    time-sharded fits, not the chunk walk."""
    if TIME_AXIS in mesh.axis_names and mesh.shape[TIME_AXIS] > 1:
        raise ValueError(
            "the sharded chunk walk needs a 1-D (series,) mesh; "
            "time-sharding belongs to the SPMD fit path (ops/seqparallel), "
            f"got axes {mesh.axis_names} with shape {dict(mesh.shape)}")
    return list(mesh.devices.flat)


def _multi_process() -> bool:
    dist = torch.distributed
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _to_rows(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(device)
    from ..models.base import to_device

    return to_device(values, device)


def distribute_panel(local_rows, mesh: Mesh) -> list:
    """This process's rows as the even split over the series-axis devices:
    one ``[rows / n, time]`` block on each device, in shard order (the
    analog of the reference's series-sharded global array, whose
    addressable shards these are).  The rows must divide evenly, as a
    sharded placement requires.  Under a multi-process group this raises
    ``NotImplementedError`` (the multi-lane walk)."""
    if _multi_process():
        raise NotImplementedError(_MULTI_PROCESS)
    devs = series_devices(mesh)
    n = int(local_rows.shape[0])
    if n % len(devs):
        raise ValueError(f"{n} rows do not split evenly over "
                         f"{len(devs)} series devices")
    size = n // len(devs)
    return [_to_rows(local_rows[i * size:(i + 1) * size], d)
            for i, d in enumerate(devs)]


def lane_values(values, mesh: Mesh, spans) -> list:
    """Place each lane's row block on its series-axis device.

    ``spans`` is the chunk-grid partition from
    ``reliability.plan.shard_spans`` (ascending, contiguous, covering the
    panel).  Returns ``[(shard_id, lo, hi, device, lane_tensor), ...]``;
    each ``lane_tensor`` holds rows ``[lo, hi)`` on ``device``.  ``values``
    is a tensor or host array (each span's rows go to their device, a view
    where they are there already) or the block list of
    :func:`distribute_panel` (the lanes ARE its blocks, so the spans must
    be its even split).  Either way the lane bytes are exactly
    ``values[lo:hi]``: the placement moves data, never changes it.
    """
    devs = series_devices(mesh)
    spans = [(int(lo), int(hi)) for lo, hi in spans]
    if len(spans) > len(devs):
        raise ValueError(
            f"{len(spans)} lane spans but only {len(devs)} series devices")
    out = []
    if isinstance(values, list):
        lo = 0
        bounds = []
        for blk in values:
            bounds.append((lo, lo + int(blk.shape[0])))
            lo += int(blk.shape[0])
        if spans != bounds[:len(spans)] or len(spans) != len(values):
            raise ValueError(
                f"distributed row blocks {bounds} do not match the "
                f"chunk-grid lane spans {spans}; choose chunk_rows so the "
                "chunk grid matches the even device split")
        for i, ((lo, hi), blk) in enumerate(zip(spans, values)):
            out.append((i, lo, hi, blk.device, blk))
        return out
    with obs_span("mesh.shard_lanes", keys=int(values.shape[0]),
                  lanes=len(spans), devices=len(devs)):
        for i, (lo, hi) in enumerate(spans):
            blk = _to_rows(values[lo:hi], devs[i])
            out.append((i, lo, hi, devs[i], blk))
    return out


def obs_span(name, **attrs):
    """Lazy obs import (parallel must stay importable before obs)."""
    from .. import obs

    return obs.span(name, **attrs)


@functools.lru_cache(maxsize=None)
def single_device_mesh() -> Mesh:
    return Mesh(_visible_cuda_devices()[:1], (SERIES_AXIS,))


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> Mesh:
    """Return the mesh of this process's devices.

    The single-process contract of the reference's entry point: with no
    coordinator and at most one process, code written against it runs
    unchanged on one card and gets :func:`default_mesh` (over
    ``local_device_ids`` when given).  An explicit coordinator or
    ``num_processes > 1`` raises ``NotImplementedError``: a multi-process
    group belongs to the multi-lane chunk walk, not ported yet.  Pod-like
    environment variables with no coordinator warn and continue on the
    local devices, as the reference does when it cannot discover one.
    """
    if (coordinator_address is not None
            or (num_processes is not None and num_processes > 1)
            or _multi_process()):
        raise NotImplementedError(_MULTI_PROCESS)
    if _on_cloud_tpu_pod():
        import warnings

        warnings.warn(
            "init_distributed: pod-like environment detected but no "
            "coordinator was given; continuing single-process on local "
            "devices", stacklevel=2)
    if local_device_ids is not None:
        return default_mesh(devices=[torch.device("cuda", int(i))
                                     for i in local_device_ids])
    return default_mesh()


def _on_cloud_tpu_pod() -> bool:
    """True when MULTI-host TPU slice metadata is present (args
    discoverable).  Single-host TPU VMs set ``TPU_WORKER_HOSTNAMES=localhost``
    — one hostname is not a pod."""
    import os

    hostnames = [h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    return len(hostnames) > 1 or bool(os.environ.get("MEGASCALE_COORDINATOR_ADDRESS"))

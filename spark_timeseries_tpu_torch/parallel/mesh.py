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

**Several processes** (the reference's ``jax.distributed``):
:func:`init_distributed` with a coordinator starts a ``torch.distributed``
process group on gloo (``init_method="tcp://<coordinator>"``) and returns
the GLOBAL mesh: every process's devices in rank order, each cell tagged
with the process that owns it (``Mesh.processes``).  The group only
coordinates — ranks, row counts, the alignment plan and the barrier
before a sharded walk's manifest merge — and no panel data goes through
it, which is why gloo is right on every box, a card's included.
:func:`distribute_panel` then returns this process's share of the global
panel (a :class:`DistributedPanel`: its row blocks on its own cells), and
:func:`lane_values` the lanes this process runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

SERIES_AXIS = "series"
TIME_AXIS = "time"

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

    def __init__(self, devices, axis_names, processes=None):
        arr = np.array(devices, dtype=object)
        for i, d in enumerate(arr.flat):
            arr.flat[i] = torch.device(d)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names) or arr.size == 0:
            raise ValueError(f"a mesh of shape {arr.shape} needs one name "
                             f"per axis and a device, got {axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        # the process owning each cell (a global mesh of a process group);
        # None: every cell is this process's
        self.processes = (None if processes is None
                          else np.asarray(processes, np.int64)
                          .reshape(arr.shape))

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


def _group() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the ``torch.distributed`` group (1 without one)."""
    return torch.distributed.get_world_size() if _group() else 1


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return torch.distributed.get_rank() if _group() else 0


def _multi_process() -> bool:
    return process_count() > 1


def cell_processes(mesh: Mesh) -> list:
    """The owning process of each series-axis cell, in shard order: the
    mesh's own tags, else (a mesh built by hand under a group) the
    contiguous even split of the cells over the group's processes."""
    n = len(series_devices(mesh))
    if mesh.processes is not None:
        return [int(v) for v in mesh.processes.reshape(n)]
    p = process_count()
    return [i * p // n for i in range(n)]


_ALIGN_RANK = ("dense", "no-trailing", "general")


class DistributedPanel:
    """This process's share of a panel spread over a process group: the
    row blocks it owns, in GLOBAL row coordinates, each on its cell's
    device — the analog of the addressable shards of the reference's
    multi-process global array.  ``shape`` is the GLOBAL ``[keys, time]``
    shape; ``blocks`` is ``[(lo, hi, device, tensor), ...]``.  A sharded
    chunk walk over it (``fit_chunked(..., mesh=)``) runs this process's
    lanes and returns its local rows."""

    is_distributed_panel = True
    ndim = 2

    def __init__(self, blocks, n_rows: int, n_time: int, dtype):
        self.blocks = [(int(lo), int(hi), d, t) for lo, hi, d, t in blocks]
        self.shape = (int(n_rows), int(n_time))
        self.dtype = dtype

    def align_mode(self) -> str:
        """The GLOBAL panel's alignment mode: each process probes its own
        blocks and the group keeps the weakest (one small all-reduce)."""
        from ..models.base import align_mode_on_host

        rank = max((_ALIGN_RANK.index(align_mode_on_host(t))
                    for _lo, _hi, _d, t in self.blocks if t.shape[0]),
                   default=0)
        if _multi_process():
            v = torch.tensor([rank], dtype=torch.int64)
            torch.distributed.all_reduce(v, op=torch.distributed.ReduceOp.MAX)
            rank = int(v.item())
        return _ALIGN_RANK[rank]

    def fingerprint(self) -> str:
        """A shape/dtype/layout identity, the same in every process of the
        job (the rows themselves are not all readable here)."""
        import hashlib

        return hashlib.sha256(
            f"global:{self.shape}:{self.dtype}:{process_count()}".encode()
        ).hexdigest()[:16]

    def __repr__(self):
        blocks = [(lo, hi, str(d)) for lo, hi, d, _t in self.blocks]
        return f"DistributedPanel(shape={self.shape}, blocks={blocks})"


def _to_rows(values, device) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.to(device)
    from ..models.base import to_device

    return to_device(values, device)


def distribute_panel(local_rows, mesh: Mesh):
    """Build the panel a sharded chunk walk runs from this process's rows.

    Single-process: the even split over the series-axis devices, one
    ``[rows / n, time]`` block on each device, in shard order (the analog
    of the reference's series-sharded global array, whose addressable
    shards these are).  Under a multi-process group: this process's rows
    split evenly over ITS cells of the global mesh, placed after the rows
    of every lower rank (the group exchanges only the row counts), as a
    :class:`DistributedPanel`.  The rows must divide evenly, as a sharded
    placement requires."""
    if _multi_process():
        return _distribute_local(local_rows, mesh)
    devs = series_devices(mesh)
    n = int(local_rows.shape[0])
    if n % len(devs):
        raise ValueError(f"{n} rows do not split evenly over "
                         f"{len(devs)} series devices")
    size = n // len(devs)
    return [_to_rows(local_rows[i * size:(i + 1) * size], d)
            for i, d in enumerate(devs)]


def _distribute_local(local_rows, mesh: Mesh) -> DistributedPanel:
    rank, size = process_index(), process_count()
    devs = series_devices(mesh)
    mine = [i for i, p in enumerate(cell_processes(mesh)) if p == rank]
    n = int(local_rows.shape[0])
    if not mine:
        raise ValueError(f"process {rank} owns no cell of {mesh}")
    if n % len(mine):
        raise ValueError(f"{n} rows do not split evenly over this "
                         f"process's {len(mine)} series devices")
    counts = [None] * size
    torch.distributed.all_gather_object(counts, n)
    lo = sum(counts[:rank])
    size_ = n // len(mine)
    blocks = []
    for k, i in enumerate(mine):
        blk = _to_rows(local_rows[k * size_:(k + 1) * size_], devs[i])
        blocks.append((lo + k * size_, lo + (k + 1) * size_, devs[i], blk))
    dtype = (local_rows.dtype if isinstance(local_rows, torch.Tensor)
             else blocks[0][3].dtype)
    return DistributedPanel(blocks, sum(counts), int(local_rows.shape[1]),
                            dtype)


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
    if getattr(values, "is_distributed_panel", False):
        # the lanes ARE this process's blocks: no data moves, but each
        # block must be a chunk-grid lane span
        by_lo = {lo: (hi, d, t) for lo, hi, d, t in values.blocks}
        claimed = set()
        for i, (lo, hi) in enumerate(spans):
            hit = by_lo.get(lo)
            if hit is None:
                continue  # another process's lane
            if hit[0] != hi:
                raise ValueError(
                    f"the distributed block at row {lo} holds "
                    f"{hit[0] - lo} rows but the chunk-grid lane wants "
                    f"{hi - lo}; choose chunk_rows so the chunk grid "
                    "matches the even device split")
            claimed.add(lo)
            out.append((i, lo, hi, hit[1], hit[2]))
        unclaimed = sorted(set(by_lo) - claimed)
        if unclaimed:
            raise ValueError(
                f"distributed blocks starting at rows {unclaimed} are not "
                "claimed by any chunk-grid lane span; choose chunk_rows so "
                "block boundaries land on the chunk grid")
        return out
    if _multi_process():
        # a panel every process holds whole: each runs its own cells' lanes
        owners = cell_processes(mesh)
        rank = process_index()
        for i, (lo, hi) in enumerate(spans):
            if owners[i] == rank:
                out.append((i, lo, hi, devs[i], _to_rows(values[lo:hi],
                                                          devs[i])))
        return out
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
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Initialize the multi-process group and return the global mesh.

    With a ``coordinator_address`` (``"host:port"``) and ``num_processes``,
    every process calls this once with its own ``process_id``: it starts a
    ``torch.distributed`` group on gloo (``init_method=
    "tcp://<coordinator>"``) and returns the 1-D ``(series,)`` mesh of every
    process's devices in rank order, each cell tagged with its owner.  The
    group coordinates the walk and moves no panel data.  This process's
    devices are ``devices`` (any torch devices, a device listed several
    times for several lanes), else the CUDA devices ``local_device_ids``,
    else every visible CUDA device.

    Safe to call when a group is already initialized (returns the global
    mesh without re-initializing); with no coordinator and at most one
    process it returns the local mesh, so code written against this entry
    point runs unchanged on one card.  Pod-like environment variables with
    no coordinator warn and continue on the local devices.
    """
    if devices is not None:
        local = [torch.device(d) for d in devices]
    elif local_device_ids is not None:
        local = [torch.device("cuda", int(i)) for i in local_device_ids]
    else:
        local = None
    dist = torch.distributed
    explicit = (coordinator_address is not None
                or (num_processes is not None and num_processes > 1))
    if explicit and not _group():
        if coordinator_address is None:
            raise ValueError(
                "init_distributed: num_processes > 1 needs the "
                "coordinator's address ('host:port')")
        if num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed: pass num_processes= and process_id= "
                "with the coordinator (nothing here discovers a cluster)")
        if not dist.is_available() or not dist.is_gloo_available():
            raise RuntimeError("torch.distributed with gloo is not "
                               "available in this build")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    elif not explicit and _on_cloud_tpu_pod():
        import warnings

        warnings.warn(
            "init_distributed: pod-like environment detected but no "
            "coordinator was given; continuing single-process on local "
            "devices", stacklevel=2)
    if local is None:
        local = _visible_cuda_devices()
    if not _multi_process():
        return default_mesh(devices=local)
    per = [None] * process_count()
    dist.all_gather_object(per, [str(d) for d in local])
    cells = [torch.device(d) for names in per for d in names]
    owners = [r for r, names in enumerate(per) for _ in names]
    return Mesh(np.array(cells, dtype=object), (SERIES_AXIS,),
                processes=owners)


def _on_cloud_tpu_pod() -> bool:
    """True when MULTI-host TPU slice metadata is present (args
    discoverable).  Single-host TPU VMs set ``TPU_WORKER_HOSTNAMES=localhost``
    — one hostname is not a pod."""
    import os

    hostnames = [h for h in os.environ.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
    return len(hostnames) > 1 or bool(os.environ.get("MEGASCALE_COORDINATOR_ADDRESS"))

"""Shard the tile-pair list over a mesh of torch devices.

Ported from the JAX package's ``parallel/sharded.py``. The unit of
distribution is the flat, slot-sorted tile-pair list of
:func:`~yet_another_wizz_tpu_torch.ops.linkage.build_tile_pairs`. Each
shard of a :class:`Mesh` counts its sub-list with the single-device engine
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.count_pairs_engine`:
kernel A, then kernel B, on a CUDA device; the plain engine on the CPU)
into a ``(num_slots, B, E)`` float32 partial, and the partials are
summed in shard order ``0..N-1`` on the first device: the counterpart of
the JAX package's ``psum``. Three catalog layouts (``data_sharding=``):

- ``replicated``: both tile sets on every device, equal contiguous chunks
  of the list;
- ``columns``: the column tile set split into equal logical tile ranges
  (:func:`~yet_another_wizz_tpu_torch.ops.tiles.shard_bounds`); shard
  ``d`` counts the pairs whose column tile it owns;
- ``ring``: both tile sets split so. At step ``s`` shard ``d`` holds row
  shard ``(d - s) mod N`` and counts the pairs between it and its own
  column shard. A row shard on another device of the process is copied
  device to device, one on the same device is read in place, and one that
  another process owns is uploaded from the host lanes, which every
  process holds alike.

The sub-lists are partitioned with stable sorts, so each stays
slot-sorted, and cached on the parent list per layout and mesh size. The
JAX package pads every chunk with dump-slot entries to bucketed lengths
(``_pad_chunk_length``, ``bucket_size``) and masks the rows a device did
not visit (``mask_always``): eager PyTorch compiles nothing per shape and
the engine's outputs are zeroed, so neither exists here.

Each shard's work is queued on the current stream of its device; the
copies that bring partials (and ring row shards) to another device order
the two devices' current streams, so the sum waits for every shard.

Multi-process jobs (:func:`~yet_another_wizz_tpu_torch.parallel.
distributed.initialize`): the mesh is global and rank-major, every
process builds the same pair list and counts the shards of its rank, and
the per-shard partials of all processes are gathered to every process
(``all_gather`` of host arrays over gloo) and summed there in the same
global shard order. A job of P processes with k shards each therefore
gives, bit for bit, the counts of one process with P·k shards. A shard
that fails raises on every process.
"""

from __future__ import annotations

import logging
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.ops.gweight import counting_width
from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
from yet_another_wizz_tpu_torch.ops.tiles import shard_bounds
from yet_another_wizz_tpu_torch.parallel.distributed import (
    num_processes,
    picklable_exception,
    process_index,
)

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "Mesh",
    "auto_mesh",
    "count_pairs_sharded",
    "default_mesh",
]

logger = logging.getLogger(__name__)

LAYOUTS = ("replicated", "columns", "ring")

NUM_DEVICES_ENV = "YAWT_NUM_DEVICES"
"""Environment override for the automatic device pool: the number of
devices the engine uses when no explicit mesh is given (``1`` pins
single-device execution; on the CPU, where the entries of a mesh share
the same cores, setting it is the only way to opt in). The counterpart of
the reference's ``YAW_NUM_THREADS`` (yaw/utils/parallel.py:53-85)."""


class Mesh:
    """An ordered tuple of torch devices, one per shard: the counterpart of
    the JAX package's one-dimensional ``Mesh`` over the axis ``"shards"``.

    A device may appear more than once; its shards then share it, as the
    JAX package's virtual CPU devices share the host (this is how one card
    runs every layout). ``ranks`` names the process that counts each shard
    in a multi-process job; they are rank-major (non-decreasing) and all 0
    by default."""

    __slots__ = ("devices", "ranks")

    def __init__(self, devices, ranks=None) -> None:
        devices = tuple(torch.device(device) for device in devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({device.type for device in devices}) != 1:
            raise ValueError("the devices of a mesh must be of one type")
        ranks = (0,) * len(devices) if ranks is None else tuple(map(int, ranks))
        if (
            len(ranks) != len(devices)
            or ranks[0] < 0
            or any(b < a for a, b in zip(ranks, ranks[1:]))
        ):
            raise ValueError("'ranks' must give each device's process, rank-major")
        self.devices = devices
        self.ranks = ranks

    @property
    def size(self) -> int:
        """Number of shards."""
        return len(self.devices)

    def local_shards(self) -> list[int]:
        """The shards this process counts."""
        rank = process_index()
        return [shard for shard, owner in enumerate(self.ranks) if owner == rank]

    def __eq__(self, other) -> bool:
        if not isinstance(other, Mesh):
            return NotImplemented
        return (self.devices, self.ranks) == (other.devices, other.ranks)

    def __hash__(self) -> int:
        return hash((self.devices, self.ranks))

    def __repr__(self) -> str:
        devices = ", ".join(str(device) for device in self.devices)
        return f"{type(self).__name__}([{devices}], ranks={list(self.ranks)})"


def default_mesh(
    num_devices: int | None = None, device: torch.device | str = "cuda"
) -> Mesh:
    """A mesh over the first ``num_devices`` devices of the job.

    In one process: ``device="cuda"`` takes the cards ``cuda:0, 1, ...``
    (all of them by default); an indexed device (``"cuda:1"``) or the CPU
    gives ``num_devices`` (default 1) entries of that one device. It never
    falls back to the CPU: a CUDA device without CUDA raises.

    In a multi-process job the mesh is global: each process contributes
    ``num_devices / num_processes`` (default 1) entries of its own device
    (``device``, or its current card for ``"cuda"``), in rank order; the
    processes exchange their device names, so every process must call this
    together."""
    from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

    device = resolve_device(device)
    processes = num_processes()
    if processes == 1:
        if device.type == "cuda" and device.index is None:
            cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
            return Mesh(cards[:num_devices])
        return Mesh([device] * (num_devices or 1))

    per_process, rest = divmod(num_devices or processes, processes)
    if per_process < 1 or rest:
        raise ValueError(
            f"a mesh of {num_devices} devices does not split over "
            f"{processes} processes"
        )
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    import torch.distributed as dist

    names = [None] * processes
    dist.all_gather_object(names, str(device))
    return Mesh(
        [name for name in names for _ in range(per_process)],
        [rank for rank in range(processes) for _ in range(per_process)],
    )


def auto_mesh(device: torch.device | str = "cuda") -> Mesh | None:
    """The mesh an engine call on ``device`` uses when none was requested,
    or None for single-device execution (the JAX package's ``auto_mesh``).

    A multi-process job always gets the global mesh (:func:`default_mesh`,
    with ``YAWT_NUM_DEVICES`` entries when that is set). In one process
    the pool is the local cards: ``device="cuda"`` spreads over all of them
    (None with one card); an indexed card is a pin (None). On the CPU the
    automatic pool stays off unless ``YAWT_NUM_DEVICES`` asks for it: its
    entries share the same cores. ``YAWT_NUM_DEVICES=1`` pins one device,
    and a malformed value is ignored with a warning."""
    from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

    device = resolve_device(device)
    env = os.environ.get(NUM_DEVICES_ENV, "").strip()
    num_devices = None
    if env:
        try:
            num_devices = int(env)
        except ValueError:
            # a broken tuning knob must not abort a measurement
            logger.warning("ignoring malformed %s=%r", NUM_DEVICES_ENV, env)
    if num_processes() > 1:
        return default_mesh(num_devices, device)
    if num_devices is not None and num_devices <= 1:
        return None
    if device.type == "cpu":
        return None if num_devices is None else default_mesh(num_devices, device)
    if device.index is not None:
        return None
    available = torch.cuda.device_count()
    num_devices = available if num_devices is None else min(num_devices, available)
    return default_mesh(num_devices, device) if num_devices > 1 else None


def resolve_mesh(mesh, device: torch.device) -> Mesh | None:
    """The mesh an engine call runs on, or None for ``device`` alone:
    ``"single"`` pins ``device``, None takes :func:`auto_mesh`, a
    :class:`Mesh` is used as it is; anything else raises ``TypeError``."""
    if mesh == "single":
        return None
    if mesh is None:
        return auto_mesh(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"'mesh' must be a Mesh, 'single' or None, got {mesh!r}")
    return mesh


def _partition(pairs: TilePairs, num_tiles1: int, num_tiles2: int,
               num_shards: int, layout: str) -> list[list[tuple]]:
    """Per shard, its steps ``(row_shard, sub_list)``: ``row_shard`` is the
    ring's row shard at that step (None: the whole row tile set), and
    ``sub_list`` the slot-sorted pairs of the step with tile indices local
    to the lanes it reads. Empty steps are left out."""
    tile1 = np.asarray(pairs.tile1, np.int64)
    tile2 = np.asarray(pairs.tile2, np.int64)
    slot = np.asarray(pairs.slot)

    def sub_list(sel, offset1: int, offset2: int) -> TilePairs:
        return TilePairs(
            tile1=(tile1[sel] - offset1).astype(np.int32),
            tile2=(tile2[sel] - offset2).astype(np.int32),
            slot=slot[sel], slot_patches=pairs.slot_patches,
        )

    if layout == "replicated":
        per_shard = -(-len(tile1) // num_shards)
        return [
            [(None, sub_list(slice(lo, lo + per_shard), 0, 0))]
            if lo < len(tile1) else []
            for lo in range(0, per_shard * num_shards, per_shard)
        ]
    def owners(tiles, num_tiles):
        """The first tile of every shard, and the shard owning each tile."""
        lo = [shard_bounds(num_tiles, num_shards, d)[0] for d in range(num_shards)]
        return lo, np.searchsorted(lo, tiles, side="right") - 1

    lo2, owner2 = owners(tile2, num_tiles2)
    steps = 1
    key = owner2
    if layout == "ring":
        lo1, owner1 = owners(tile1, num_tiles1)
        steps = num_shards
        key = owner2 * steps + (owner2 - owner1) % num_shards
    order = np.argsort(key, kind="stable")  # slot-sorted within each bucket
    bounds = np.searchsorted(key[order], np.arange(num_shards * steps + 1))
    plan = []
    for d in range(num_shards):
        shard_steps = []
        for s in range(steps):
            sel = order[bounds[d * steps + s] : bounds[d * steps + s + 1]]
            if len(sel) == 0:
                continue
            if layout == "ring":
                row = (d - s) % num_shards
                shard_steps.append((row, sub_list(sel, lo1[row], lo2[d])))
            else:
                shard_steps.append((None, sub_list(sel, 0, lo2[d])))
        plan.append(shard_steps)
    return plan


def _shard_plan(pairs, tiles1, tiles2, num_shards: int, layout: str):
    """:func:`_partition` of ``pairs``, computed once per layout and mesh
    size and cached on the pair list (with it the sub-lists' own uploaded
    index tensors)."""
    key = ("shards", layout, num_shards)
    plan = pairs._device_cache.get(key)
    if plan is None:
        plan = _partition(
            pairs, tiles1.num_tiles, tiles2.num_tiles, num_shards, layout
        )
        pairs._device_cache[key] = plan
    return plan


def _upload(array: NDArray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card from pinned memory without
    blocking (the pinned block stays reserved until the copy is done)."""
    host = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def _row_lanes(tiles1, mesh, row, device, devices) -> torch.Tensor:
    """The row lanes a step reads on ``device``: the whole tile set, or
    the ring's row shard ``row``, read in place where it lives on
    ``device``, else copied from the device of the process that holds it,
    else uploaded from the host lanes."""
    if row is None:
        return tiles1.device_data(device)
    shard = (mesh.size, row)
    if row in devices:
        return tiles1.device_data(devices[row], shard=shard).to(
            device, non_blocking=True
        )
    lo, hi = shard_bounds(tiles1.num_tiles, *shard)
    return _upload(tiles1.lane_data[lo:hi], device)


def _count_shard(tiles1, tiles2, steps, table, *, mesh, layout, shard,
                 devices, backend, direct) -> torch.Tensor:
    """One shard's ``(num_slots, B, E)`` float32 partial on its device: the
    engine over each of its steps, the steps summed in order."""
    from yet_another_wizz_tpu_torch.ops.paircount import (
        _device_table,
        count_pairs_engine,
    )

    device = devices[shard]
    table = _device_table(table.tobytes(), table.shape, device)
    if layout == "replicated":
        lanes2 = tiles2.device_data(device)
    else:
        lanes2 = tiles2.device_data(device, shard=(mesh.size, shard))
    total = None
    for row, sub_list in steps:
        lanes1 = _row_lanes(tiles1, mesh, row, device, devices)
        counts = count_pairs_engine(
            lanes1, lanes2, sub_list, table, backend=backend,
            cols_binned=tiles2.binned, direct=direct,
        )
        total = counts if total is None else total.add_(counts)
    return total


def _sum_partials(partials: list, device: torch.device) -> torch.Tensor | None:
    """The sum of the partials (None entries skipped) on ``device``, added
    in list order: the reduction over the mesh (the JAX ``psum``)."""
    total = None
    for partial in partials:
        if partial is None:
            continue
        partial = partial.to(device, non_blocking=True)
        total = partial if total is None else total.add_(partial)
    return total


def _gather_partials(partials: dict, error, mesh: Mesh, shape) -> torch.Tensor:
    """Multi-process reduction: every process sends its shards' partials,
    or the exception that stopped them, to all processes, which raise if
    any process failed and else sum all shards' partials in shard order
    on the host."""
    import torch.distributed as dist

    payload = None
    if error is None:
        try:
            payload = ("ok", {
                shard: None if partial is None else partial.cpu().numpy()
                for shard, partial in partials.items()
            })
        except Exception as exc:
            error = exc
    if error is not None:
        payload = ("error", picklable_exception(error))
    gathered = [None] * num_processes()
    dist.all_gather_object(gathered, payload)
    for rank, (status, value) in enumerate(gathered):
        if status == "error":
            raise RuntimeError(f"sharded count failed on process {rank}") from value
    by_shard = {}
    for _, value in gathered:
        by_shard.update(value)
    total = _sum_partials(
        [None if by_shard[d] is None else torch.from_numpy(by_shard[d])
         for d in range(mesh.size)],
        torch.device("cpu"),
    )
    return torch.zeros(shape, dtype=torch.float32) if total is None else total


def count_pairs_sharded(
    tiles1: TileSet,
    tiles2: TileSet,
    pairs: TilePairs,
    chord2_table: NDArray,
    *,
    mesh: Mesh | None = None,
    data_sharding: str = "replicated",
    backend: str = "auto",
    defer: bool = False,
    direct: tuple | None = None,
) -> NDArray | torch.Tensor:
    """Pair counting over a mesh, with the result contract of
    :func:`yet_another_wizz_tpu_torch.ops.paircount.count_pairs_tiles`:
    float64 ``(num_slots, B, E)`` counts.

    ``mesh`` defaults to :func:`default_mesh`; ``data_sharding`` is one of
    the layouts of the module docstring. ``backend`` chooses each shard's
    engine as in :func:`~yet_another_wizz_tpu_torch.ops.paircount.
    count_pairs_engine`. With ``defer=True`` (single-process
    jobs) the float32 sum is returned on the mesh's first device as soon
    as the work is queued."""
    if mesh is None:
        mesh = default_mesh()
    if not isinstance(mesh, Mesh):
        raise TypeError(f"'mesh' must be a Mesh, got {type(mesh).__name__}")
    if data_sharding not in LAYOUTS:
        raise ValueError(f"unknown data_sharding '{data_sharding}'")
    if backend not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown backend '{backend}' for a mesh")
    if mesh.ranks[-1] >= num_processes():
        raise ValueError(f"{mesh} names processes this job does not have")
    from yet_another_wizz_tpu_torch.ops.paircount import resolve_device

    local = mesh.local_shards()
    devices = {shard: resolve_device(mesh.devices[shard]) for shard in local}
    if backend == "cuda" and mesh.devices[0].type != "cuda":
        raise ValueError(f"backend 'cuda' needs a mesh of CUDA devices, got {mesh}")
    table = np.ascontiguousarray(chord2_table, np.float32)
    shape = (pairs.num_slots, table.shape[0], counting_width(table.shape[1], direct))
    if pairs.num_pairs == 0:
        return np.zeros(shape, dtype=np.float64)

    plan = _shard_plan(pairs, tiles1, tiles2, mesh.size, data_sharding)
    partials = {}
    error = None
    for shard in local:
        try:
            partials[shard] = (
                _count_shard(
                    tiles1, tiles2, plan[shard], table, mesh=mesh,
                    layout=data_sharding, shard=shard, devices=devices,
                    backend=backend, direct=direct,
                )
                if plan[shard] else None
            )
        except Exception as exc:
            if num_processes() == 1:
                raise
            error = exc
            break
    if num_processes() > 1:
        total = _gather_partials(partials, error, mesh, shape)
        return total.numpy().astype(np.float64)

    first = devices[local[0]]
    total = _sum_partials([partials[shard] for shard in local], first)
    if total is None:
        total = torch.zeros(shape, dtype=torch.float32, device=first)
    if defer:
        return total
    return total.cpu().numpy().astype(np.float64)

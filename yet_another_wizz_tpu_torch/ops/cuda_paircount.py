"""Wrappers of the hand-written CUDA pair-count kernels (``csrc/paircount.cu``).

The kernels replace ``yet_another_wizz_tpu/ops/pallas_paircount.py::
_paircount_kernel`` in all of its variants (ROADMAP K1.1-K1.5):

- ``paircount_partials`` (kernel A) computes the ``(B, E)`` block of every
  entry of the tile-pair list into ``partial[k]``; its variants count
  cumulatively or with direct separation weights (small-angle or arcsine
  index), against unbinned or binned columns;
- ``segment_sum`` (kernel B) sums each slot's contiguous run of partials
  into ``out[slot]``;
- ``boundary_flags_cuda`` (kernel C) is the exactness audit's flag pass
  (ROADMAP K2.1, which the JAX package runs in XLA): one flag per tile pair,
  set when a valid pair lies within the audit band of an edge of its row's
  bin.

Together they are deterministic: no float atomics, a summation order fixed
by the shapes alone. Kernel A is bound by float32 issue: the compensated
chord, a compare and an add per counting edge, and in direct mode the
separation weight of each pair that an edge counts. Every instance
evaluates only the column chunks that a warp's rows can reach:
each warp (32 consecutive rows) tests its chunk cap against every column
chunk's (:func:`~yet_another_wizz_tpu_torch.ops.tiles.chunk_caps`, derived
from the lanes by :func:`_device_caps`) and skips the chunks beyond its
rows' largest threshold or, with binned columns, in other bins; a skipped
pair would have added +0, so the result is bit for bit the per-pair
evaluation's
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_keep_mask` is the
rule's plain mirror). A warp ballots its column chunks' tests into a mask
first and counts the blocks it keeps as the mask's population count; each
thread block adds its warps' counts once to a 64-bit total per device that
is never reset (:func:`_kept_total`). The host reads the totals, after the
work queued on the card, whenever it reads its counters
(:func:`~yet_another_wizz_tpu_torch.utils.tracing.snapshot`,
:func:`_pull_kept`), and adds what it has not seen yet to the counter
``engine.chunk_blocks_kept``. :func:`count_pairs_cuda` counts the blocks
the launches decide on, tile pairs times ``(T / 32)^2`` per launch, into
``engine.chunk_blocks`` (on the CPU the plain mirror counts both,
:func:`~yet_another_wizz_tpu_torch.ops.paircount.count_chunk_blocks_plain`),
cumulative and direct launches alike. The direct instances take the base
weight of a pair's (bin, sub-interval) from a table the block fills in shared memory with the same ``expf``, walk only the
below/above entries of the pair's own sub-interval (grouped from the table
itself by :func:`~yet_another_wizz_tpu_torch.ops.gweight.entry_layout`,
once per table, held in shared memory, any number of them), and skip the weight of a pair beyond
its row's largest threshold or, with binned columns, in another bin: such
a pair adds 0 to every count. The TPU kernel's row-side precompute
(per-row thresholds gathered into device memory ahead of the kernel) is
dropped: kernel A gathers each row's thresholds from the table in shared
memory once per tile pair.

Kernel B is bound by device memory bytes. One block per slot reads the
slot's run in coalesced loads. With ``W = B * E`` values per entry and
``cols = min(W, 256)``, the block's ``256 // cols`` groups of threads take
consecutive entries: group ``g`` sums entries ``g, g + groups, ...`` of
the run in entry order, per column, and the groups' sums are combined by a
fixed pairwise tree (group ``g`` adds group ``g + h`` for ``h = 1, 2, 4,
...``). The order of the sum is therefore fixed by ``W`` and the run's
length; it is not list order, which the plain version follows on the CPU.
Two runs are bitwise equal.

Kernel C is three launches per group of 16 edges, with no host
synchronisation between them: C0 computes the reach of every row chunk
once (its rows' largest ``t + band``; plain mirror
:func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_reach`), C1 triages
every tile pair from the chunk caps and that reach alone into a work list
of (tile pair, row chunk, column-chunk mask) items (plain mirror
:func:`~yet_another_wizz_tpu_torch.ops.paircount.flag_work_items`), and C2,
a persistent grid, evaluates the items' chunk blocks with the column
chunks staged by ``cp.async`` and ends a tile pair at its first hit. The
flags start at zero and are only ever set, so they do not depend on the
order of the items; they are bit for bit those of the plain version,
:func:`~yet_another_wizz_tpu_torch.ops.paircount.boundary_flags_torch`.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use, once per
counting mode and in parallel, into ``build/yawt_torch_kernels/`` and
loaded with ``ctypes``. The wrappers take CUDA tensors only and raise for
any other device (:mod:`.paircount` chooses the plain versions for the
CPU). Each launch adds one to the counter
``engine.launches.<variant>`` of
:mod:`~yet_another_wizz_tpu_torch.utils.tracing` (kernel C's three
launches, one each of :data:`FLAG_KERNELS`).
"""

from __future__ import annotations

import ctypes
import os
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING

import torch

from yet_another_wizz_tpu_torch.ops.gweight import counting_width, entry_layout
from yet_another_wizz_tpu_torch.ops.linkage import _pair_index
from yet_another_wizz_tpu_torch.ops.paircount import (
    FLAG_ITEM_CHUNKS,
    MAX_EDGES_PER_LAUNCH,
    chunk_blocks,
)
from yet_another_wizz_tpu_torch.ops.tiles import CHUNK_SIZE, _device_caps
from yet_another_wizz_tpu_torch.utils.misc import (
    build_directory,
    build_shared_library,
)
from yet_another_wizz_tpu_torch.utils import tracing
from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "KEPT_BLOCKS",
    "LAUNCHES",
    "MAX_EDGES_PER_LAUNCH",
    "SOURCE",
    "boundary_flags_cuda",
    "build",
    "count_pairs_cuda",
    "decode_work_items",
    "flag_reach_cuda",
    "flag_triage_cuda",
    "paircount_partials",
    "prepare_lanes",
    "segment_sum",
    "variant_name",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paircount.cu"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",  # no FMA contraction in the chord and weight arithmetic
    "-Xptxas", "-v",  # registers, shared memory and spills in the build log
    "-shared", "-Xcompiler", "-fPIC",
]

MODES = ("cumulative", "direct", "arcsine")
"""Counting modes, one library each (``-DYAWT_DIRECT=0, 1, 2``): cumulative,
direct with the small-angle index, direct with the arcsine index."""

_SHARED_MEMORY_EXCEEDED = -1
"""Status of a kernel-A launch that needs more shared memory than one
block may have."""

FLAG_KERNELS = ("boundary_flags_reach", "boundary_flags_triage", "boundary_flags")
"""The launch counters' variant names (``engine.launches.<name>``) of
kernel C's launches C0 (reach), C1 (triage) and C2 (evaluation), in launch
order."""

LAUNCHES = "engine.launches."
"""The prefix of the launch counters' names; the variant follows."""

KEPT_BLOCKS = "engine.chunk_blocks_kept"
"""The counter of the chunk blocks kernel A kept."""


def variant_name(cols_binned: bool, direct: tuple | None) -> str:
    """The launch counter's variant name of a kernel-A variant."""
    if direct is None:
        name = "paircount_partials"
    else:
        name = "paircount_partials_" + MODES[_mode(direct)]
    return name + "_binned" if cols_binned else name


def _mode(direct: tuple | None) -> int:
    if direct is None:
        return 0
    return 1 if len(direct) > 3 and direct[3] else 2


_libs: dict[int, ctypes.CDLL] = {}
_lib_lock = threading.Lock()


def _load(path: Path, mode: int) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.yawt_paircount_mode.restype = i32
    if lib.yawt_paircount_mode() != mode:
        raise RuntimeError(f"{path} was not built for counting mode {mode}")
    lib.yawt_paircount_chunk.restype = i32
    if lib.yawt_paircount_chunk() != CHUNK_SIZE:
        raise RuntimeError(f"{path} does not read chunks of {CHUNK_SIZE} points")
    if not hasattr(lib, "yawt_kept_total_bytes"):
        raise RuntimeError(f"{path} was built without the kept-block total")
    lib.yawt_kept_total_bytes.restype = i32
    if lib.yawt_kept_total_bytes() != 8:
        raise RuntimeError(f"{path} does not keep a 64-bit kept-block total")
    lib.yawt_paircount_partials.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, ptr, i32, ptr, ptr, ptr,
    ]
    lib.yawt_paircount_partials.restype = i32
    if mode == 0:
        lib.yawt_segment_sum.argtypes = [ptr, ptr, i64, i32, ptr, ptr]
        lib.yawt_segment_sum.restype = i32
        _bind_flags(lib)
    return lib


def _bind_flags(lib: ctypes.CDLL) -> None:
    """Bind kernel C's C interface, where the cumulative library has it (a
    library of an earlier source without it runs kernels A and B only;
    scripts/torch_cumulative_variants.py binds an earlier flag kernel
    itself)."""
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "yawt_flag_item_chunks"):
        lib.yawt_flag_item_chunks.restype = i32
        if lib.yawt_flag_item_chunks() != FLAG_ITEM_CHUNKS:
            raise RuntimeError(
                f"{path} does not group {FLAG_ITEM_CHUNKS} column chunks per "
                "work item"
            )
        lib.yawt_boundary_flags.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, i64, i64, ptr, ptr,
            i32, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
        ]
        lib.yawt_boundary_flags.restype = i32
        lib.yawt_flag_reach.argtypes = [
            ptr, ptr, i64, ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr,
        ]
        lib.yawt_flag_reach.restype = i32
        lib.yawt_flag_triage.argtypes = [
            ptr, ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr, ptr, ptr, ptr,
        ]
        lib.yawt_flag_triage.restype = i32


def build() -> str:
    """Compile (when the source is newer than the libraries) and load the
    kernels: one ``nvcc`` process per counting mode, all started together.
    Returns the compilers' output, empty when nothing was built."""
    with _lib_lock:
        if _libs:
            return ""
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
        directory = build_directory("yawt_torch_kernels")
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
        targets = [
            directory / f"libyawt_paircount_{name}.so" for name in MODES
        ]

        def compile_mode(mode: int) -> str:
            return build_shared_library(
                [nvcc, *NVCC_FLAGS, f"-DYAWT_DIRECT={mode}"],
                [SOURCE], targets[mode], timeout=600,
            )

        with ThreadPoolExecutor(len(MODES)) as pool:
            logs = list(pool.map(compile_mode, range(len(MODES))))
        libs = {mode: _load(target, mode) for mode, target in enumerate(targets)}
        _libs.update(libs)
        return "".join(
            f"[{MODES[mode]}]\n{log}" for mode, log in enumerate(logs) if log
        )


def _check(tensor: torch.Tensor, name: str, dtype, ndim, device) -> None:
    if tensor.device != device:
        raise ValueError(f"'{name}' is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise TypeError(f"'{name}' must be {dtype}, got {tensor.dtype}")
    if tensor.dim() != ndim:
        raise ValueError(f"'{name}' must have {ndim} dimensions")
    if not tensor.is_contiguous():
        raise ValueError(f"'{name}' must be contiguous")


def _raise_on_error(status: int, kernel: str) -> None:
    if status != 0:
        raise RuntimeError(f"launching {kernel} failed with CUDA error {status}")


_layouts: dict[int, tuple[int, tuple, torch.Tensor]] = {}
"""Entry layouts by ``id`` of the table they were derived from, with the
table's version counter and direct specification."""


def _device_layout(
    table: torch.Tensor, num_edges: int, direct: tuple
) -> torch.Tensor:
    """The entries of a combined direct-mode table grouped by
    :func:`~yet_another_wizz_tpu_torch.ops.gweight.entry_layout`, as its
    packed int32 buffer on the table's device: the only source of the
    layout the kernel reads. Derived from a host copy of the table on its
    first use and cached until the table is freed or changed in place."""
    key = id(table)
    cached = _layouts.get(key)
    if cached is not None and cached[:2] == (table._version, direct):
        return cached[2]
    if cached is None:
        weakref.finalize(table, _layouts.pop, key, None)
    layout = entry_layout(
        table[:, num_edges:].cpu().numpy(), num_sub=direct[0],
        num_below=direct[1], num_above=direct[2],
    )
    buffer = torch.from_numpy(layout.packed()).to(table.device)
    _layouts[key] = (table._version, direct, buffer)
    return buffer


_kept_lock = threading.Lock()
_kept_totals: dict[torch.device, torch.Tensor] = {}
"""Per device, the int64 total of the chunk blocks kernel A kept there
(one zeroing per device and process; never reset)."""
_kept_seen: dict[torch.device, int] = {}
"""Per device, the total the host has read last: what it has counted."""


def _kept_total(device: torch.device) -> torch.Tensor:
    """The device's kept-block total that kernel A adds to."""
    with _kept_lock:
        total = _kept_totals.get(device)
        if total is None:
            total = torch.zeros(1, dtype=torch.int64, device=device)
            _kept_totals[device] = total
        return total


def _pull_kept() -> None:
    """Count what kernel A has kept on each device since the
    last read (:data:`KEPT_BLOCKS`). Waits for the work queued on the
    devices that have a total, so the blocks count together with the
    launches that ``engine.chunk_blocks`` counted on the host; the counters'
    readers call it (:func:`~yet_another_wizz_tpu_torch.utils.tracing.
    pull_from`)."""
    with _kept_lock:
        for device, total in _kept_totals.items():
            torch.cuda.synchronize(device)
            now = int(total.item())
            seen = _kept_seen.get(device, 0)
            _kept_seen[device] = now
            if now > seen:
                count(KEPT_BLOCKS, now - seen)


tracing.pull_from(_pull_kept)


def prepare_lanes(tiles: TileSet, device: torch.device | str) -> torch.Tensor:
    """Upload the lanes of ``tiles`` to the CUDA ``device``
    (:meth:`~yet_another_wizz_tpu_torch.ops.tiles.TileSet.device_data`) and
    derive their chunk caps (:func:`_device_caps`), so that the counts
    reading them later find both in place; returns the lanes."""
    lanes = tiles.device_data(device)
    _device_caps(lanes)
    return lanes


def paircount_partials(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    direct: tuple | None = None,
) -> torch.Tensor:
    """``(P, B, E)`` float32 block of every tile pair ``(tile1[k],
    tile2[k])`` (kernel A). ``lanes*`` are ``(N, 8, T)`` float32 tiles
    (``T`` a multiple of 32 on the card, where the kernel skips the
    column chunks no row of a warp reaches by the lanes' chunk caps,
    :func:`_device_caps`), ``tile*`` int32 indices,
    ``chord2_table`` the ``(B, E)`` float32 thresholds or, with ``direct = (num_sub, num_below, num_above,
    small_angle)``, the ``(B, E + C)`` combined table of
    :meth:`~yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges.combined_table`.
    ``cols_binned`` counts a column only where its bin equals the row's.
    The kernel adds the chunk blocks it keeps to the device's
    kept-block total. In direct mode it reads
    the table's entries as the layout of :func:`_device_layout`, derived
    from this table. Launches on the
    current stream and does not synchronise (except to derive that layout
    on a table's first use); raises where the layout does not fit in a
    block's shared memory."""
    num_edges = counting_width(chord2_table.shape[1], direct)
    if lanes1.device.type != "cuda":
        raise ValueError(f"no pair-count kernel for device {lanes1.device}")
    device = lanes1.device
    _check(lanes1, "lanes1", torch.float32, 3, device)
    _check(lanes2, "lanes2", torch.float32, 3, device)
    _check(tile1, "tile1", torch.int32, 1, device)
    _check(tile2, "tile2", torch.int32, 1, device)
    _check(chord2_table, "chord2_table", torch.float32, 2, device)
    num_tiles1, channels, tile_size = lanes1.shape
    if channels != 8 or tuple(lanes2.shape[1:]) != (8, tile_size):
        raise ValueError("lanes must be (N, 8, T) with one tile size T")
    if tile1.shape != tile2.shape:
        raise ValueError("'tile1' and 'tile2' differ in length")
    num_pairs = len(tile1)
    num_bins, table_width = chord2_table.shape
    caps_ptrs = (
        _device_caps(lanes1).data_ptr(), _device_caps(lanes2).data_ptr()
    )
    kept_ptr = _kept_total(device).data_ptr()
    num_sub, num_entries, layout_ptr = 0, 0, None
    if direct is not None:
        num_sub = direct[0]
        layout = _device_layout(chord2_table, num_edges, direct)
        num_entries = (len(layout) - 3 * num_bins * num_sub) // 2
        layout_ptr = layout.data_ptr()
    partial = torch.empty(
        (num_pairs, num_bins, num_edges), dtype=torch.float32, device=device
    )
    if num_pairs == 0:
        return partial

    build()
    lib = _libs[_mode(direct)]
    name = variant_name(cols_binned, direct)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for edge0 in range(0, num_edges, MAX_EDGES_PER_LAUNCH):
            num_group = min(MAX_EDGES_PER_LAUNCH, num_edges - edge0)
            status = lib.yawt_paircount_partials(
                lanes1.data_ptr(), lanes2.data_ptr(), *caps_ptrs,
                tile1.data_ptr(), tile2.data_ptr(), num_pairs,
                chord2_table.data_ptr(), num_bins, table_width, num_edges,
                edge0, num_group, tile_size, int(cols_binned), num_sub,
                layout_ptr, num_entries, partial.data_ptr(), kept_ptr, stream,
            )
            if status == _SHARED_MEMORY_EXCEEDED:
                raise ValueError(
                    f"{name}: tiles of {tile_size} points with {num_bins} "
                    f"bins x {num_sub} sub-intervals and {num_entries} "
                    "below/above entries need more shared memory than one "
                    "block of this card has"
                )
            _raise_on_error(status, name)
            count(LAUNCHES + name)
    return partial


def segment_sum(
    partial: torch.Tensor,
    slot: torch.Tensor,
    offsets: torch.Tensor,
    num_slots: int,
) -> torch.Tensor:
    """``(num_slots, B, E)`` float32 sums of the slot-sorted partials
    (kernel B): slot ``s`` sums ``partial[offsets[s]:offsets[s + 1]]``,
    zero for an empty run, in the fixed order of the module docstring.
    The kernel reads ``offsets`` (int64, ``num_slots + 1``); ``slot``, the
    input of the plain version
    (:func:`~yet_another_wizz_tpu_torch.ops.paircount.segment_sum_torch`),
    is not read."""
    if partial.device.type != "cuda":
        raise ValueError(f"no segment-sum kernel for device {partial.device}")
    device = partial.device
    _check(partial, "partial", torch.float32, 3, device)
    _check(offsets, "offsets", torch.int64, 1, device)
    if len(offsets) != num_slots + 1:
        raise ValueError("'offsets' must hold num_slots + 1 run bounds")
    width = partial.shape[1] * partial.shape[2]
    out = torch.empty(
        (num_slots, *partial.shape[1:]), dtype=torch.float32, device=device
    )
    if num_slots * width == 0:
        return out

    build()
    with torch.cuda.device(device):
        status = _libs[0].yawt_segment_sum(
            partial.data_ptr(), offsets.data_ptr(), num_slots, width,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on_error(status, "segment_sum")
        count(LAUNCHES + "paircount_segment_sum")
    return out


def _check_flag_inputs(lanes1, lanes2, tile1, tile2, *tables):
    """Raises for inputs kernel C does not take (``tables``: the threshold
    and band tables, where given); returns ``(T / 32, runs)``, the chunks
    per tile and the work items per row chunk."""
    device = lanes1.device
    if device.type != "cuda":
        raise ValueError(f"the flag kernel needs CUDA tensors, got {device}")
    _check(lanes1, "lanes1", torch.float32, 3, device)
    _check(lanes2, "lanes2", torch.float32, 3, device)
    _check(tile1, "tile1", torch.int32, 1, device)
    _check(tile2, "tile2", torch.int32, 1, device)
    for table, name in zip(tables, ("chord2_table", "band_table")):
        _check(table, name, torch.float32, 2, device)
    _, channels, tile_size = lanes1.shape
    if channels != 8 or tuple(lanes2.shape[1:]) != (8, tile_size):
        raise ValueError("lanes must be (N, 8, T) with one tile size T")
    if tile1.shape != tile2.shape:
        raise ValueError("'tile1' and 'tile2' differ in length")
    if len({table.shape for table in tables}) > 1:
        raise ValueError("'band_table' and 'chord2_table' differ in shape")
    if lanes2.data_ptr() % 16:
        raise ValueError("'lanes2' must be 16-byte aligned (cp.async)")
    chunks = tile_size // CHUNK_SIZE
    runs = -(-chunks // FLAG_ITEM_CHUNKS)
    if tile_size % CHUNK_SIZE or chunks * runs >= 1 << 16:
        raise ValueError(f"the flag kernel takes no tiles of {tile_size} points")
    return chunks, runs


def _flag_workspace(lanes1, num_pairs, chunks, runs):
    """One int32 allocation from PyTorch's caching allocator, for one call:
    the two counters, C1's ``(P * K * G, 2)`` work list and C0's ``(N1,
    K)`` float32 reach, in this order (the work list 8-byte aligned), and
    the byte offsets of the last two."""
    num_items = num_pairs * chunks * runs
    workspace = torch.empty(
        2 + 2 * num_items + len(lanes1) * chunks, dtype=torch.int32,
        device=lanes1.device,
    )
    return workspace, 8, 8 + 8 * num_items


def boundary_flags_cuda(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    cols_binned: bool = False,
) -> torch.Tensor:
    """``(P,)`` bool on the card: does any valid pair of tile pair
    ``(tile1[k], tile2[k])`` lie within ``band_table`` of a threshold of
    its row's bin (kernel C, the audit's flag pass)? ``lanes*`` are ``(N,
    8, T)`` float32 tiles on a CUDA device (``T`` a multiple of 32: the
    kernel reads the lanes' chunk caps, :func:`_device_caps`), ``tile*``
    int32 indices, ``chord2_table`` and ``band_table`` ``(B, E)``
    float32. Three launches (reach, triage, evaluation) per group of 16
    edges, on the current stream, without synchronising; the workspace is
    allocated per call. Raises for tensors the kernel does not take."""
    chunks, runs = _check_flag_inputs(
        lanes1, lanes2, tile1, tile2, chord2_table, band_table
    )
    device = lanes1.device
    num_pairs = len(tile1)
    num_bins, num_edges = chord2_table.shape
    caps1, caps2 = _device_caps(lanes1), _device_caps(lanes2)
    flags = torch.zeros(num_pairs, dtype=torch.bool, device=device)
    if num_pairs == 0:
        return flags

    build()
    workspace, items, reach = _flag_workspace(lanes1, num_pairs, chunks, runs)
    counters = workspace.data_ptr()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for edge0 in range(0, num_edges, MAX_EDGES_PER_LAUNCH):
            status = _libs[0].yawt_boundary_flags(
                lanes1.data_ptr(), lanes2.data_ptr(), caps1.data_ptr(),
                caps2.data_ptr(), tile1.data_ptr(), tile2.data_ptr(),
                len(lanes1), num_pairs, chord2_table.data_ptr(),
                band_table.data_ptr(), num_bins, num_edges, edge0,
                min(MAX_EDGES_PER_LAUNCH, num_edges - edge0),
                lanes1.shape[2], int(cols_binned), counters + reach,
                counters + items, counters, flags.data_ptr(), stream,
            )
            _raise_on_error(status, "boundary_flags")
            for name in FLAG_KERNELS:
                count(LAUNCHES + name)
    return flags


def flag_reach_cuda(
    lanes1: torch.Tensor,
    chord2_table: torch.Tensor,
    band_table: torch.Tensor,
    *,
    edge0: int = 0,
) -> torch.Tensor:
    """``(N1, T / 32)`` float32: kernel C's first launch (C0) alone, the
    reach of every row chunk for the edges ``[edge0, edge0 + 16)``, as
    :func:`boundary_flags_cuda` launches it (plain mirror:
    :func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_reach` of those
    edges). On the current stream, without synchronising."""
    index = torch.zeros(0, dtype=torch.int32, device=lanes1.device)
    chunks, runs = _check_flag_inputs(
        lanes1, lanes1, index, index, chord2_table, band_table
    )
    num_bins, num_edges = chord2_table.shape
    workspace, _, reach = _flag_workspace(lanes1, 0, chunks, runs)
    build()
    with torch.cuda.device(lanes1.device):
        status = _libs[0].yawt_flag_reach(
            lanes1.data_ptr(), _device_caps(lanes1).data_ptr(), len(lanes1),
            chord2_table.data_ptr(), band_table.data_ptr(), num_bins,
            num_edges, edge0, min(MAX_EDGES_PER_LAUNCH, num_edges - edge0),
            lanes1.shape[2], workspace.data_ptr() + reach,
            workspace.data_ptr(),
            torch.cuda.current_stream(lanes1.device).cuda_stream,
        )
        _raise_on_error(status, "boundary_flags_reach")
        count(LAUNCHES + "boundary_flags_reach")
    return workspace[reach // 4 :].view(torch.float32).view(len(lanes1), chunks)


def flag_triage_cuda(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    reach: torch.Tensor,
    *,
    cols_binned: bool = False,
    flags: torch.Tensor | None = None,
    edge0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's second launch (C1) alone, after :func:`flag_reach_cuda`:
    ``(items, length)``, the ``(P * K * G, 2)`` int32 work list, whose first
    ``length`` rows (a one-element int32 tensor on the card) hold ``(entry,
    unit << 16 | mask)`` in the order of the atomics. With ``edge0 > 0``
    the entries set in ``flags`` get no items. On the current stream,
    without synchronising; :func:`decode_work_items` sorts the list."""
    chunks, runs = _check_flag_inputs(lanes1, lanes2, tile1, tile2)
    if edge0 > 0 and flags is None:
        raise ValueError("a later group of edges needs the earlier flags")
    num_pairs = len(tile1)
    workspace, items, _ = _flag_workspace(lanes1, num_pairs, chunks, runs)
    workspace[:2].zero_()
    build()
    with torch.cuda.device(lanes1.device):
        status = _libs[0].yawt_flag_triage(
            _device_caps(lanes1).data_ptr(), _device_caps(lanes2).data_ptr(),
            reach.data_ptr(), tile1.data_ptr(), tile2.data_ptr(), num_pairs,
            lanes1.shape[2], edge0, int(cols_binned),
            None if flags is None else flags.data_ptr(),
            workspace.data_ptr() + items, workspace.data_ptr(),
            torch.cuda.current_stream(lanes1.device).cuda_stream,
        )
        _raise_on_error(status, "boundary_flags_triage")
        count(LAUNCHES + "boundary_flags_triage")
    return workspace[2 : 2 + 2 * num_pairs * chunks * runs].view(-1, 2), workspace[:1]


def decode_work_items(items: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """``(M, 3)`` int64 ``(entry, unit, mask)`` on the host, sorted: the
    work list of :func:`flag_triage_cuda` in the layout of its plain mirror
    :func:`~yet_another_wizz_tpu_torch.ops.paircount.flag_work_items`.
    Synchronises."""
    words = items[: int(length.item())].cpu().long() & 0xFFFFFFFF
    decoded = torch.stack(
        [words[:, 0], words[:, 1] >> 16, words[:, 1] & 0xFFFF], dim=1
    )
    order = torch.argsort(decoded[:, 0] * (1 << 16) + decoded[:, 1])
    return decoded[order]


def count_pairs_cuda(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    pairs: TilePairs,
    chord2_table: torch.Tensor,
    *,
    cols_binned: bool = False,
    direct: tuple | None = None,
) -> torch.Tensor:
    """``(num_slots, B, E)`` float32 cumulative counts per patch-pair slot
    of a slot-sorted tile-pair list: kernel A, then kernel B, queued on the
    current stream of the lanes' CUDA device. Adds the list's tile pairs
    and candidate pairs to the counters ``engine.tile_pairs`` and
    ``engine.candidate_pairs`` and its launches' chunk blocks to
    ``engine.chunk_blocks``; the kernel counts the kept blocks, which the
    host reads with its counters (:func:`_pull_kept`)."""
    if len(pairs.tile1) and (
        int(pairs.tile1.max()) >= len(lanes1)
        or int(pairs.tile2.max()) >= len(lanes2)
    ):
        raise ValueError("tile-pair list indexes past the tile sets")
    if lanes1.device.type != "cuda":
        raise ValueError(f"no pair-count kernel for device {lanes1.device}")
    index = _pair_index(pairs, lanes1.device)
    num_pairs = int(pairs.num_pairs)
    count("engine.tile_pairs", num_pairs)
    count("engine.candidate_pairs", num_pairs * lanes1.shape[2] * lanes2.shape[2])
    count("engine.chunk_blocks", chunk_blocks(
        num_pairs, lanes1.shape[2], counting_width(chord2_table.shape[1], direct),
    ))
    partial = paircount_partials(
        lanes1, lanes2, index.tile1, index.tile2, chord2_table,
        cols_binned=cols_binned, direct=direct,
    )
    return segment_sum(partial, index.slot, index.offsets, pairs.num_slots)

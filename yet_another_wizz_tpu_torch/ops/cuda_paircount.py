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
separation weight of each pair that an edge counts. Its cumulative
instances evaluate only the column chunks that a warp's rows can reach:
each warp (32 consecutive rows) tests its chunk cap against every column
chunk's (:func:`~yet_another_wizz_tpu_torch.ops.tiles.chunk_caps`, derived
from the lanes by :func:`_device_caps`) and skips the chunks beyond its
rows' largest threshold or, with binned columns, in other bins; a skipped
pair would have added +0, so the result is bit for bit the per-pair
evaluation's
(:func:`~yet_another_wizz_tpu_torch.ops.paircount.chunk_keep_mask` is the
rule's plain mirror). Its direct instances take the base weight of a
pair's (bin, sub-interval) from a table the block fills in shared memory with the same ``expf``, walk only the
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
loaded with ``ctypes``. A wrapper given CPU tensors runs the kernel's
plain PyTorch version from :mod:`.paircount` instead; on a CUDA tensor it
launches the kernel or raises (kernel C's wrapper takes CUDA tensors only:
:func:`~yet_another_wizz_tpu_torch.ops.paircount.boundary_flags` picks the
plain version for the CPU). Each launch adds one to the counter
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

import numpy as np
import torch

from yet_another_wizz_tpu_torch.ops.gweight import counting_width, entry_layout
from yet_another_wizz_tpu_torch.ops.paircount import (
    FLAG_ITEM_CHUNKS,
    partial_counts_torch,
    segment_sum_torch,
)
from yet_another_wizz_tpu_torch.ops.tiles import CHUNK_SIZE, chunk_caps
from yet_another_wizz_tpu_torch.utils.misc import (
    build_directory,
    build_shared_library,
)
from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "LAUNCHES",
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

MAX_EDGES_PER_LAUNCH = 16
"""Counting edges one launch of kernel A covers (its per-thread
accumulators are sized at compile time); wider tables take one launch per
group."""

_SHARED_MEMORY_EXCEEDED = -1
"""Status of a kernel-A launch that needs more shared memory than one
block may have."""

FLAG_KERNELS = ("boundary_flags_reach", "boundary_flags_triage", "boundary_flags")
"""The launch counters' variant names (``engine.launches.<name>``) of
kernel C's launches C0 (reach), C1 (triage) and C2 (evaluation), in launch
order."""

LAUNCHES = "engine.launches."
"""The prefix of the launch counters' names; the variant follows."""


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
    lib.yawt_paircount_partials.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i64, ptr,
        i32, i32, i32, i32, i32, i32, i32, i32, ptr, i32, ptr, ptr,
    ]
    lib.yawt_paircount_partials.restype = i32
    if mode == 0:
        lib.yawt_segment_sum.argtypes = [ptr, ptr, i64, i32, ptr, ptr]
        lib.yawt_segment_sum.restype = i32
    # a library of an earlier source without them runs kernels A and B only
    # (scripts/torch_cumulative_variants.py binds its flag kernel itself)
    if mode == 0 and hasattr(lib, "yawt_flag_item_chunks"):
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
    return lib


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


def _table_layout(table: torch.Tensor, direct: tuple | None) -> int:
    """Counting edges of a (possibly combined) table; raises for a table
    that does not fit the direct specification."""
    num_edges = counting_width(table.shape[1], direct)
    if num_edges < 1:
        raise ValueError(
            f"table of width {table.shape[1]} has no counting edges for the "
            f"direct specification {direct}"
        )
    return num_edges


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


_caps: dict[int, tuple[int, torch.Tensor]] = {}
"""Chunk caps by ``id`` of the lanes they were derived from, with the
lanes' version counter."""


def _device_caps(lanes: torch.Tensor) -> torch.Tensor:
    """The :func:`~yet_another_wizz_tpu_torch.ops.tiles.chunk_caps` of
    ``lanes`` on their device: the only source of the caps the cumulative
    kernel reads. Derived on the lanes' first use and cached until they are
    freed or changed in place."""
    key = id(lanes)
    cached = _caps.get(key)
    if cached is not None and cached[0] == lanes._version:
        return cached[1]
    if cached is None:
        weakref.finalize(lanes, _caps.pop, key, None)
    caps = chunk_caps(lanes)
    _caps[key] = (lanes._version, caps)
    return caps


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
    (``T`` a multiple of 32 for the cumulative kernel on the card, which
    skips the column chunks no row of a warp reaches by the lanes' chunk
    caps, :func:`_device_caps`), ``tile*`` int32 indices,
    ``chord2_table`` the ``(B, E)`` float32 thresholds or, with ``direct = (num_sub, num_below, num_above,
    small_angle)``, the ``(B, E + C)`` combined table of
    :meth:`~yet_another_wizz_tpu_torch.ops.thresholds.DirectEdges.combined_table`.
    ``cols_binned`` counts a column only where its bin equals the row's.
    In direct mode the kernel reads the table's entries as the layout of
    :func:`_device_layout`, derived from this table. Launches on the
    current stream and does not synchronise (except to derive that layout
    on a table's first use); raises where the layout does not fit in a
    block's shared memory."""
    num_edges = _table_layout(chord2_table, direct)
    if lanes1.device.type == "cpu":
        return partial_counts_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), chord2_table,
            cols_binned=cols_binned, direct=direct,
        )
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
    caps_ptrs, num_sub, num_entries, layout_ptr = (None, None), 0, 0, None
    if direct is None:
        caps_ptrs = (
            _device_caps(lanes1).data_ptr(), _device_caps(lanes2).data_ptr()
        )
    else:
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
                layout_ptr, num_entries, partial.data_ptr(), stream,
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
    ``slot`` feeds the plain version on the CPU, ``offsets`` (int64,
    ``num_slots + 1``) the kernel."""
    if partial.device.type == "cpu":
        return segment_sum_torch(partial, slot, num_slots)
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


class _PairIndex:
    """A tile-pair list's index tensors on one device."""

    __slots__ = ("tile1", "tile2", "slot", "offsets")

    def __init__(self, pairs: TilePairs, device: torch.device) -> None:
        slot = np.asarray(pairs.slot, np.int64)
        if len(slot) and (
            np.any(np.diff(slot) < 0) or slot[0] < 0
            or slot[-1] >= pairs.num_slots
        ):
            raise ValueError("the tile-pair list must be sorted by slot")
        offsets = np.searchsorted(slot, np.arange(pairs.num_slots + 1))

        def upload(array, dtype):
            return torch.from_numpy(np.ascontiguousarray(array, dtype)).to(device)

        self.tile1 = upload(pairs.tile1, np.int32)
        self.tile2 = upload(pairs.tile2, np.int32)
        self.slot = upload(slot, np.int64)
        self.offsets = upload(offsets, np.int64)


def _pair_index(pairs: TilePairs, device: torch.device) -> _PairIndex:
    """The index tensors and slot run offsets of ``pairs`` on ``device``,
    computed once and cached on the pair list."""
    key = ("pair_index", device)
    index = pairs._device_cache.get(key)
    if index is None:
        count("cache.miss.pair_index")
        index = _PairIndex(pairs, device)
        pairs._device_cache[key] = index
    else:
        count("cache.hit.pair_index")
    return index


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
    current stream (or their plain versions for CPU tensors). Adds the
    list's tile pairs and candidate pairs to the counters
    ``engine.tile_pairs`` and ``engine.candidate_pairs``."""
    if len(pairs.tile1) and (
        int(pairs.tile1.max()) >= len(lanes1)
        or int(pairs.tile2.max()) >= len(lanes2)
    ):
        raise ValueError("tile-pair list indexes past the tile sets")
    index = _pair_index(pairs, lanes1.device)
    num_pairs = int(pairs.num_pairs)
    count("engine.tile_pairs", num_pairs)
    count("engine.candidate_pairs", num_pairs * lanes1.shape[2] * lanes2.shape[2])
    partial = paircount_partials(
        lanes1, lanes2, index.tile1, index.tile2, chord2_table,
        cols_binned=cols_binned, direct=direct,
    )
    return segment_sum(partial, index.slot, index.offsets, pairs.num_slots)

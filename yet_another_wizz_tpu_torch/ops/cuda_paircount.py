"""Wrappers of the hand-written CUDA pair-count kernels (``csrc/paircount.cu``).

The kernels replace ``yet_another_wizz_tpu/ops/pallas_paircount.py::
_paircount_kernel`` in its cumulative, unbinned-column variant (ROADMAP
K1.1: crosscorrelate DD, DR, RD):

- ``paircount_partials`` (kernel A) computes the ``(B, E)`` block of every
  entry of the tile-pair list into ``partial[k]``;
- ``segment_sum`` (kernel B) sums each slot's contiguous run of partials
  in list order into ``out[slot]``.

Together they are deterministic: no float atomics, fixed summation order.
They are bound by float32 ALU work, about 20 operations per candidate pair
(the compensated chord plus a compare and an add per edge). The TPU
kernel's row-side precompute (per-row thresholds gathered into device
memory ahead of the kernel) is dropped: kernel A gathers each row's
thresholds from the table in shared memory once per tile pair.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use into
``build/yawt_torch_kernels/`` and loaded with ``ctypes``. A wrapper given
CPU tensors runs the kernel's plain PyTorch version from
:mod:`.paircount` instead; on a CUDA tensor it launches the kernel or
raises. Each launch adds one to :data:`launch_counts`.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.ops.paircount import (
    partial_counts_torch,
    segment_sum_torch,
)
from yet_another_wizz_tpu_torch.utils.misc import (
    build_directory,
    build_shared_library,
)

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.ops.linkage import TilePairs

__all__ = [
    "SOURCE",
    "build",
    "count_pairs_cuda",
    "launch_counts",
    "paircount_partials",
    "reset_launch_counts",
    "segment_sum",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "paircount.cu"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "--fmad=false",  # no FMA contraction in the chord arithmetic
    "-Xptxas", "-v",  # registers, shared memory and spills in the build log
    "-shared", "-Xcompiler", "-fPIC",
]

MAX_EDGES_PER_LAUNCH = 16
"""Edges one launch of kernel A counts (its per-thread accumulators are
sized at compile time); wider tables take one launch per group."""

launch_counts = {"paircount_partials": 0, "paircount_segment_sum": 0}
"""Kernel launches in this process, by kernel name."""

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    """Set every launch count to zero."""
    for name in launch_counts:
        launch_counts[name] = 0


def build() -> str:
    """Compile (when the source is newer than the library) and load the
    kernels. Returns the compiler's output, empty when nothing was built."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return ""
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
        target = build_directory("yawt_torch_kernels") / "libyawt_paircount.so"
        log = build_shared_library(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS],
            [SOURCE], target, timeout=600,
        )
        lib = ctypes.CDLL(str(target))
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.yawt_paircount_partials.argtypes = [
            ptr, ptr, ptr, ptr, i64, ptr, i32, i32, i32, i32, i32, ptr, ptr,
        ]
        lib.yawt_paircount_partials.restype = i32
        lib.yawt_segment_sum.argtypes = [ptr, ptr, i64, i32, ptr, ptr]
        lib.yawt_segment_sum.restype = i32
        _lib = lib
        return log


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


def paircount_partials(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    tile1: torch.Tensor,
    tile2: torch.Tensor,
    chord2_table: torch.Tensor,
) -> torch.Tensor:
    """``(P, B, E)`` float32 block of every tile pair ``(tile1[k],
    tile2[k])`` (kernel A). ``lanes*`` are ``(N, 8, T)`` float32 tiles,
    ``tile*`` int32 indices, ``chord2_table`` the ``(B, E)`` float32
    thresholds. Launches on the current stream and does not synchronise."""
    if lanes1.device.type == "cpu":
        return partial_counts_torch(
            lanes1, lanes2, tile1.long(), tile2.long(), chord2_table
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
    num_bins, num_edges = chord2_table.shape
    partial = torch.empty(
        (num_pairs, num_bins, num_edges), dtype=torch.float32, device=device
    )
    if num_pairs == 0:
        return partial

    build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for edge0 in range(0, num_edges, MAX_EDGES_PER_LAUNCH):
            num_sub = min(MAX_EDGES_PER_LAUNCH, num_edges - edge0)
            status = _lib.yawt_paircount_partials(
                lanes1.data_ptr(), lanes2.data_ptr(),
                tile1.data_ptr(), tile2.data_ptr(), num_pairs,
                chord2_table.data_ptr(), num_bins, num_edges, edge0, num_sub,
                tile_size, partial.data_ptr(), stream,
            )
            _raise_on_error(status, "paircount_partials")
            launch_counts["paircount_partials"] += 1
    return partial


def segment_sum(
    partial: torch.Tensor,
    slot: torch.Tensor,
    offsets: torch.Tensor,
    num_slots: int,
) -> torch.Tensor:
    """``(num_slots, B, E)`` float32 sums of the slot-sorted partials
    (kernel B): slot ``s`` sums ``partial[offsets[s]:offsets[s + 1]]`` in
    list order, zero for an empty run. ``slot`` feeds the plain version on
    the CPU, ``offsets`` (int64, ``num_slots + 1``) the kernel."""
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
        status = _lib.yawt_segment_sum(
            partial.data_ptr(), offsets.data_ptr(), num_slots, width,
            out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
        )
        _raise_on_error(status, "segment_sum")
        launch_counts["paircount_segment_sum"] += 1
    return out


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
        index = _PairIndex(pairs, device)
        pairs._device_cache[key] = index
    return index


def count_pairs_cuda(
    lanes1: torch.Tensor,
    lanes2: torch.Tensor,
    pairs: TilePairs,
    chord2_table: torch.Tensor,
) -> torch.Tensor:
    """``(num_slots, B, E)`` float32 cumulative counts per patch-pair slot
    of a slot-sorted tile-pair list: kernel A, then kernel B, queued on the
    current stream (or their plain versions for CPU tensors)."""
    if len(pairs.tile1) and (
        int(pairs.tile1.max()) >= len(lanes1)
        or int(pairs.tile2.max()) >= len(lanes2)
    ):
        raise ValueError("tile-pair list indexes past the tile sets")
    index = _pair_index(pairs, lanes1.device)
    partial = paircount_partials(
        lanes1, lanes2, index.tile1, index.tile2, chord2_table
    )
    return segment_sum(partial, index.slot, index.offsets, pairs.num_slots)

"""ctypes bindings for the native host kernels in ``tilepack.cpp``.

The source is the JAX package's ``_native/tilepack.cpp``, copied. It is
compiled with ``g++`` at first use into ``build/yawt_torch_native/`` beside
the package and rebuilt when the source is newer. Every consumer checks
:func:`enabled` and falls back to numpy when no compiler is available.

Set ``YAWT_DISABLE_NATIVE=1`` to force the numpy implementations.

The JAX package's host ingestion helpers (``assign_patches_radec``,
``counting_argsort_ids``, ``gather_rows``, ``gather_i32_to_f64``, the
``NATIVE_ENABLED`` flag) and its fixed-point encoder are not bound: the
port assigns large chunks to patches on the card, splits them with numpy
and asks :func:`enabled` (``ROADMAP.md``, R6 and R7).
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
import threading
from pathlib import Path

import numpy as np

from yet_another_wizz_tpu_torch.utils.misc import (
    build_directory,
    build_shared_library,
    env_flag,
)

__all__ = [
    "assign_patches",
    "enabled",
    "env_flag",
    "filter_tile_pairs",
    "gather_f64",
    "gather_i32",
    "interleave_columns",
    "min_dist2_update",
    "morton_codes",
    "pack_tiles",
    "patch_geometry",
    "radec_to_xyz",
    "sort_order",
    "tile_caps",
    "tile_max_chord",
]

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).parent / "tilepack.cpp"

# -ffp-contract=off pins the no-FMA evaluation the numpy parity tests rely
# on: gcc's default contracts a*b - c*d into FMA where the ISA has it as
# baseline (aarch64), perturbing the tile-pair filter bound by ~1 ulp vs
# numpy's two-op evaluation.
_COMMAND = ["g++", "-O3", "-ffp-contract=off", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_loaded = False
_load_lock = threading.Lock()


def _bind(lib) -> None:
    i64 = ctypes.c_int64
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    lib.morton_codes.argtypes = [f64p, i64, ctypes.c_int32, i64p]
    lib.assign_patches.argtypes = [f64p, i64, f64p, i64, i32p]
    lib.pack_tiles.argtypes = [f64p, f64p, f64p, i64p, i64, i64, f32p]
    lib.tile_center_sums.argtypes = [f64p, i64p, i64, i64, f64p]
    lib.tile_max_chord.argtypes = [f64p, i64p, i64, i64, f64p, f64p]
    lib.min_dist2_update.argtypes = [f64p, i64, f64p, f64p]
    lib.interleave_columns.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), i64, i64, i64, f64p
    ]
    lib.interleave_columns.restype = ctypes.c_int
    lib.patch_geometry.argtypes = [
        f64p, ctypes.c_void_p, i32p, i64, i64, f64p, f64p
    ]
    lib.filter_tile_pairs.argtypes = [
        i64p, i64p, i64p, i64p, i64,            # slot starts/sizes
        f64p, f64p, f64p, f64p,                 # caps 1 (+ cos/sin radii)
        f64p, f64p, f64p, f64p,                 # caps 2 (+ cos/sin radii)
        ctypes.c_double, ctypes.c_double,       # cutoff, cos(cutoff)
        ctypes.c_double, ctypes.c_int32,        # sin(cutoff), per_tile mode
        ctypes.c_void_p, ctypes.c_void_p,       # zmin1/zmax1 (optional)
        ctypes.c_void_p, ctypes.c_void_p,       # zmin2/zmax2 (optional)
        ctypes.c_void_p, ctypes.c_void_p,       # range_max + cos table
        ctypes.c_void_p, i64,                   # sin table (all optional)
        i64p,                                   # per-slot kept counts
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
    ]
    lib.filter_tile_pairs.restype = i64
    lib.make_sort_keys.argtypes = [
        i32p, i32p, i64p, i64, ctypes.c_int32, ctypes.c_int32, u64p
    ]
    lib.radix_argsort.argtypes = [u64p, i64, i64p]
    lib.gather_f64.argtypes = [f64p, i64p, i64, i64, f64p]
    lib.gather_i32.argtypes = [i32p, i64p, i64, i32p]
    lib.radec_to_xyz_strided.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_void_p, i64, i64, f64p
    ]


def enabled() -> bool:
    """Whether the native library is available; builds and loads it on
    the first call."""
    global _lib, _loaded
    if _loaded:
        return _lib is not None
    with _load_lock:
        if not _loaded:
            if not env_flag("YAWT_DISABLE_NATIVE"):
                target = build_directory("yawt_torch_native") / "libtilepack.so"
                try:
                    build_shared_library(_COMMAND, [_SOURCE], target, 120)
                    lib = ctypes.CDLL(str(target))
                    _bind(lib)
                    _lib = lib
                except (OSError, subprocess.SubprocessError) as err:
                    logger.warning("native tilepack library unavailable: %s", err)
            _loaded = True
    return _lib is not None


def morton_codes(xyz: np.ndarray, bits: int = 10) -> np.ndarray:
    """Native Morton codes (see ops.tiles for the numpy fallback)."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    out = np.empty(len(xyz), dtype=np.int64)
    _lib.morton_codes(xyz, len(xyz), bits, out)
    return out


def pack_tiles(
    xyz: np.ndarray,
    weights: np.ndarray,
    zbins: np.ndarray,
    dest: np.ndarray,
    num_tiles: int,
    tile_size: int,
) -> np.ndarray:
    """Scatter points into the packed (num_tiles, 8, T) float32 layout."""
    lane_data = np.zeros((num_tiles, 8, tile_size), dtype=np.float32)
    _lib.pack_tiles(
        np.ascontiguousarray(xyz, np.float64),
        np.ascontiguousarray(weights, np.float64),
        np.ascontiguousarray(zbins, np.float64),
        np.ascontiguousarray(dest, np.int64),
        len(xyz),
        tile_size,
        lane_data,
    )
    return lane_data


def tile_max_chord(
    xyz: np.ndarray, dest: np.ndarray, tile_size: int, centers: np.ndarray
) -> np.ndarray:
    """Per-tile maximum chord distance of the points (tile ``dest //
    tile_size``) to the given tile centers."""
    max_chord = np.zeros(len(centers))
    _lib.tile_max_chord(
        np.ascontiguousarray(xyz, np.float64),
        np.ascontiguousarray(dest, np.int64),
        len(xyz), tile_size,
        np.ascontiguousarray(centers, np.float64), max_chord,
    )
    return max_chord


def tile_caps(
    xyz: np.ndarray,
    dest: np.ndarray,
    num_tiles: int,
    tile_size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tile cap centers (unit vectors) and radii (chord distances)."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    dest = np.ascontiguousarray(dest, np.int64)
    sums = np.zeros((num_tiles, 3), dtype=np.float64)
    _lib.tile_center_sums(xyz, dest, len(xyz), tile_size, sums)
    norms = np.linalg.norm(sums, axis=1)
    centers = np.zeros((num_tiles, 3))
    centers[:, 0] = 1.0
    nonempty = norms > 0
    centers[nonempty] = sums[nonempty] / norms[nonempty, None]
    return centers, tile_max_chord(xyz, dest, tile_size, centers)


def filter_tile_pairs(
    start1: np.ndarray,
    start2: np.ndarray,
    n1: np.ndarray,
    n2: np.ndarray,
    centers1: np.ndarray,
    radii1: np.ndarray,
    centers2: np.ndarray,
    radii2: np.ndarray,
    *,
    cutoff_angle: float = 0.0,
    per_tile: int = 0,
    zmin1: np.ndarray | None = None,
    zmax1: np.ndarray | None = None,
    zmin2: np.ndarray | None = None,
    zmax2: np.ndarray | None = None,
    range_max: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cap-pruned tile-pair enumeration over linked patch-pair slots (the
    build_tile_pairs hot loop; see ops/linkage.py for the numpy fallback
    and tilepack.cpp for the predicate contract). Two native passes: a
    sizing pass, then a fill pass into exactly-sized outputs — peak
    memory is the RESULT, never the candidate grid. All trig is
    precomputed HERE with numpy (per-tile cos/sin of the cap radii plus
    the theta table) so the kernel's cosine-form cap test sees the exact
    inputs the numpy fallback computes for itself."""
    num_slots = len(start1)
    radii1 = np.ascontiguousarray(radii1, np.float64)
    radii2 = np.ascontiguousarray(radii2, np.float64)
    args = [
        np.ascontiguousarray(start1, np.int64),
        np.ascontiguousarray(start2, np.int64),
        np.ascontiguousarray(n1, np.int64),
        np.ascontiguousarray(n2, np.int64),
        num_slots,
        np.ascontiguousarray(centers1, np.float64),
        radii1,
        np.cos(radii1),
        np.sin(radii1),
        np.ascontiguousarray(centers2, np.float64),
        radii2,
        np.cos(radii2),
        np.sin(radii2),
        float(cutoff_angle),
        float(np.cos(cutoff_angle)),
        float(np.sin(cutoff_angle)),
        int(per_tile),
    ]
    holders = []  # keep the contiguous copies alive across both calls

    def opt(arr, dtype):
        if arr is None:
            return None
        arr = np.ascontiguousarray(arr, dtype)
        holders.append(arr)
        return arr.ctypes.data

    args += [
        opt(zmin1, np.int32), opt(zmax1, np.int32),
        opt(zmin2, np.int32), opt(zmax2, np.int32),
        opt(range_max, np.float64),
        opt(None if range_max is None else np.cos(range_max), np.float64),
        opt(None if range_max is None else np.sin(range_max), np.float64),
        0 if range_max is None else range_max.shape[1],
    ]
    slot_counts = np.empty(num_slots, dtype=np.int64)
    total = _lib.filter_tile_pairs(
        *args, slot_counts, None, None, None
    )
    tile1 = np.empty(total, dtype=np.int32)
    tile2 = np.empty(total, dtype=np.int32)
    slot = np.empty(total, dtype=np.int32)
    _lib.filter_tile_pairs(
        *args, slot_counts,
        tile1.ctypes.data, tile2.ctypes.data, slot.ctypes.data,
    )
    return tile1, tile2, slot


def sort_order(
    patch_ids: np.ndarray,
    zbins: np.ndarray | None,
    morton: np.ndarray,
    *,
    morton_bits: int = 30,
) -> np.ndarray:
    """Stable argsort by (patch, zbin, morton) — the tile-layout sort —
    as ONE parallel radix pass set over a composite uint64 key, replacing
    ``np.lexsort``'s three stable single-threaded argsorts. ``zbins=None``
    sorts by (patch, morton) only (the "spatial" layout)."""
    n = len(morton)
    patch_ids = np.ascontiguousarray(patch_ids, np.int32)
    morton = np.ascontiguousarray(morton, np.int64)
    keys = np.empty(n, dtype=np.uint64)
    if zbins is None:
        zb = np.zeros(n, dtype=np.int32)
        zbin_bits = 0
    else:
        zb = np.ascontiguousarray(zbins, np.int32)
        zbin_bits = 16
    _lib.make_sort_keys(patch_ids, zb, morton, n, zbin_bits,
                        morton_bits, keys)
    order = np.empty(n, dtype=np.int64)
    _lib.radix_argsort(keys, n, order)
    return order


def gather_f64(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order]`` for float64 arrays of shape (n,) or (n, k)."""
    src = np.ascontiguousarray(src, np.float64)
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty((len(order), *src.shape[1:]), dtype=np.float64)
    k = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    _lib.gather_f64(src, order, len(order), k, out)
    return out


def gather_i32(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order]`` for int32 arrays."""
    src = np.ascontiguousarray(src, np.int32)
    order = np.ascontiguousarray(order, np.int64)
    out = np.empty(len(order), dtype=np.int32)
    _lib.gather_i32(src, order, len(order), out)
    return out


def assign_patches(xyz: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest-center argmax assignment without score-matrix temporaries."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    centers = np.ascontiguousarray(centers, np.float64)
    out = np.empty(len(xyz), dtype=np.int32)
    _lib.assign_patches(xyz, len(xyz), centers, len(centers), out)
    return out


def _strided_f8(arr: np.ndarray) -> tuple[np.ndarray, int, int]:
    """``(array, data pointer, byte stride)`` for a 1-D float64 input.

    Float64 1-D views pass through WITHOUT copying whatever their stride
    (structured-array columns — the catalog chunk layout — are exactly
    such views); anything else is converted once. The returned array must
    stay referenced for the pointer's lifetime.
    """
    arr = np.asarray(arr)
    if arr.dtype != np.float64 or arr.ndim != 1:
        arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data, arr.strides[0]


def radec_to_xyz(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """Unit-sphere 3-vectors from (ra, dec) in radian (single write pass).

    Strided float64 inputs (structured-array columns) convert in place —
    no ascontiguousarray copies."""
    ra, ra_ptr, ra_stride = _strided_f8(ra)
    dec, dec_ptr, dec_stride = _strided_f8(dec)
    out = np.empty((len(ra), 3), dtype=np.float64)
    _lib.radec_to_xyz_strided(ra_ptr, ra_stride, dec_ptr, dec_stride,
                              len(ra), out)
    return out


def patch_geometry(
    xyz: np.ndarray,
    weights: np.ndarray | None,
    patch_ids: np.ndarray,
    num_patches: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-patch cap centers (weighted spherical means) and angular radii."""
    xyz = np.ascontiguousarray(xyz, dtype=np.float64)
    ids = np.ascontiguousarray(patch_ids, dtype=np.int32)
    centers = np.empty((num_patches, 3), dtype=np.float64)
    radii = np.empty(num_patches, dtype=np.float64)
    w_ptr = None
    if weights is not None:
        weights = np.ascontiguousarray(weights, dtype=np.float64)
        w_ptr = weights.ctypes.data
    _lib.patch_geometry(
        xyz, w_ptr, ids, len(xyz), num_patches, centers, radii
    )
    return centers, radii


def min_dist2_update(
    xyz: np.ndarray, center: np.ndarray, min_d2: np.ndarray
) -> None:
    """In-place ``min_d2 = minimum(min_d2, |xyz - center|^2)`` (no
    temporaries; the numpy expression allocates three catalog-sized
    intermediates per call)."""
    _lib.min_dist2_update(
        xyz, len(xyz), np.ascontiguousarray(center, np.float64), min_d2
    )


def interleave_columns(columns, out: np.ndarray) -> int:
    """Interleave float64 column arrays into ``out`` (an (n, k) float64
    view of a record array) with a fused finite check. Returns the lowest
    index of any non-finite column in the ORDER THE COLUMNS ARE PASSED
    (the caller passes them in dtype field order, so the error message
    matches the numpy fallback's first-error when the values dict shares
    that order), or -1 on success."""
    ptrs = (ctypes.c_void_p * len(columns))(
        *(c.ctypes.data for c in columns)
    )
    stride = out.strides[0] // 8
    return _lib.interleave_columns(
        ptrs, len(columns), len(out), stride, out
    )

"""Device-friendly catalog layout: spatially sorted, padded point tiles.

The reference implementation builds one scipy kd-tree per (patch, redshift
bin) (yaw/catalog/trees.py:365-429). The device engine wants dense tile
arithmetic instead, so a catalog becomes a :class:`TileSet`:

- points are sorted by (patch id, Morton code of the unit-sphere position),
  so that consecutive points are spatial neighbours;
- each patch is zero-padded to a multiple of the tile size ``T``;
- every ``T`` consecutive points form a *tile* with a bounding cap
  (center + opening angle) used to prune distant tile pairs — the tile-level
  analogue of the kd-tree's node bounds;
- per-point data is packed into a single float32 array of shape
  ``(num_tiles, 8, T)`` (channels x points): unit-sphere xyz split into
  (hi, lo) float32 pairs for small-angle precision, the pair weight, and
  the redshift-bin index. The layout, the sort and ``T = 512`` are the JAX
  package's, so both packages build byte-identical tiles and identical
  tile-pair lists.

Weights of padding points are zero, so they never contribute to counts.
Lanes cross to the device as these float32 arrays, 32 B per point, copied
from pinned host memory (:meth:`TileSet.device_data`); the JAX package's
fixed-point link encoding is not ported. From the lanes,
:func:`chunk_caps` derives a bounding sphere and bin range per run of 32
consecutive points, from which the cumulative CUDA kernel skips the column
chunks that none of a warp's rows can reach.
The packing hot path (Morton codes, the scatter into the packed layout,
tile caps) uses the native C++ kernels from
:mod:`yet_another_wizz_tpu_torch._native` when available, with numpy fallbacks.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch import _native
from yet_another_wizz_tpu_torch.coordinates import chord_to_angle
from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from numpy.typing import NDArray

__all__ = [
    "TileSet",
    "build_tile_set",
    "chunk_caps",
    "morton_codes",
    "preferred_tile_layout",
    "shard_bounds",
]

CHANNEL_XYZ_HI = slice(0, 3)
CHANNEL_XYZ_LO = slice(3, 6)
CHANNEL_WEIGHT = 6
CHANNEL_ZBIN = 7
NUM_CHANNELS = 8

DEFAULT_TILE_SIZE = 512

CHUNK_SIZE = 32
"""Points per chunk cap (``kChunk`` in ``csrc/paircount.cu`` must match):
one warp's rows, and the run of columns a warp skips as a whole."""

CAP_SLACK = 1e-5
"""Absolute slack added to every chunk cap's radius (unit-sphere chord
units). The cap test is a PRUNE: a skipped pair must lie beyond the float32
squared chord the kernel would compute for it. That compensated chord is
within a few float32 ulps of the exact chord of the lanes (relative ~3e-7,
under 1e-6 absolute for chords up to 2), and the kernel's float32 cap test
rounds about as much; 1e-5 on each radius dwarfs both, and admits only
chunk pairs within ~2e-5 rad (4 arcsec) of the exact boundary."""

CAP_WIDTH = 8
"""float32 values per chunk cap: center x, y, z, radius, lowest and
highest bin, two zeros (two 16-byte loads)."""


def shard_bounds(num_tiles: int, num_shards: int, shard: int) -> tuple[int, int]:
    """``[lo, hi)`` tile range that shard ``shard`` of ``num_shards`` owns
    when a tile set is split into equal logical ranges of ``ceil(num_tiles
    / num_shards)`` tiles (the JAX package's ``_shard_tiles``); the last
    shards may be short or empty."""
    logical = max(1, -(-num_tiles // num_shards))
    lo = min(shard * logical, num_tiles)
    return lo, min(lo + logical, num_tiles)


def chunk_caps(lanes: torch.Tensor, chunk_size: int = CHUNK_SIZE) -> torch.Tensor:
    """Bounding spheres and bin ranges of the chunks of ``chunk_size``
    consecutive points of each tile, ``(N, T / chunk_size, 8)`` float32 on
    the device of the ``(N, 8, T)`` lanes.

    Only points of nonzero weight are covered: a zero-weight point adds
    +-0 wherever it lies (padding has weight 0). Positions are the lanes'
    ``hi + lo`` in float64 (exact), so a tile set converted from the JAX
    package gets the same caps. The center is the chunk's mean rounded to
    float32; the radius is the float64 distance to the farthest covered
    point plus :data:`CAP_SLACK`, rounded up to float32. A chunk without
    such points has radius ``-inf`` and the empty bin range ``(+inf,
    -inf)``: no pair of it is ever evaluated."""
    num_tiles, channels, tile_size = lanes.shape
    if channels != NUM_CHANNELS or tile_size % chunk_size:
        raise ValueError(
            f"lanes of shape {tuple(lanes.shape)} do not split into chunks "
            f"of {chunk_size} points"
        )
    num_chunks = tile_size // chunk_size
    data = lanes.double().view(num_tiles, NUM_CHANNELS, num_chunks, chunk_size)
    xyz = data[:, CHANNEL_XYZ_HI] + data[:, CHANNEL_XYZ_LO]  # (N, 3, K, C)
    covered = data[:, CHANNEL_WEIGHT] != 0  # (N, K, C)
    num_covered = covered.sum(dim=-1)
    zero = torch.zeros((), dtype=xyz.dtype, device=xyz.device)
    mean = torch.where(covered[:, None], xyz, zero).sum(dim=-1) / num_covered.clamp(
        min=1
    )[:, None]
    center = mean.float()  # (N, 3, K)
    distance = (
        (xyz - center.double()[..., None]) ** 2
    ).sum(dim=1).sqrt()  # (N, K, C)
    radius = torch.where(covered, distance, zero).amax(dim=-1) + CAP_SLACK
    radius32 = radius.float()
    inf = torch.tensor(float("inf"), device=xyz.device)
    radius32 = torch.where(
        radius32.double() < radius, torch.nextafter(radius32, inf), radius32
    )
    empty = num_covered == 0
    bins = data[:, CHANNEL_ZBIN]
    caps = torch.zeros(
        (num_tiles, num_chunks, CAP_WIDTH), dtype=torch.float32,
        device=lanes.device,
    )
    caps[..., 0:3] = center.transpose(1, 2)
    caps[..., 3] = torch.where(empty, -inf, radius32)
    caps[..., 4] = torch.where(covered, bins, inf.double()).amin(dim=-1).float()
    caps[..., 5] = torch.where(covered, bins, -inf.double()).amax(dim=-1).float()
    return caps


_caps: dict[int, tuple[int, torch.Tensor]] = {}
"""Chunk caps by ``id`` of the lanes they were derived from, with the
lanes' version counter."""


def _device_caps(lanes: torch.Tensor) -> torch.Tensor:
    """The :func:`chunk_caps` of ``lanes`` on their device: the only source
    of the caps the CUDA kernels read, and of those the plain engine counts
    its chunk blocks with. Derived on the lanes' first use and cached until
    they are freed or changed in place."""
    key = id(lanes)
    cached = _caps.get(key)
    if cached is not None and cached[0] == lanes._version:
        return cached[1]
    if cached is None:
        weakref.finalize(lanes, _caps.pop, key, None)
    caps = chunk_caps(lanes)
    _caps[key] = (lanes._version, caps)
    return caps


def preferred_tile_layout(
    catalog,
    num_bins: int,
    max_angle: float,
    *,
    equal_bin_counting: bool,
    tile_size: int | None = None,
) -> str:
    """Choose the tile layout for a binned tile set of a measurement.

    The ``zmajor`` layout (bin-coherent tiles) enables per-tile
    angular-cutoff pruning and disjoint-bin dropping in
    :func:`~yet_another_wizz_tpu_torch.ops.linkage.build_tile_pairs`, but inflates
    tile bounding-cap radii by ~sqrt(num_bins) because a redshift slice
    spreads over the whole patch footprint.

    For equal-bin counting (both sides binned, autocorrelation style) the
    disjoint-bin drop divides the pair grid by ~num_bins, cancelling the
    radius inflation in the worst case and winning outright whenever the
    angular cutoff contributes — so zmajor is used unconditionally. For
    binned-rows/unbinned-columns counting there is no disjoint drop, so
    zmajor pays off only when the angular cutoff dominates the inflated cap
    radii (large scales, dense catalogs, or many small patches).
    """
    if num_bins <= 0:
        return "spatial"
    if equal_bin_counting:
        return "zmajor"
    if tile_size is None:
        tile_size = DEFAULT_TILE_SIZE
    counts = np.asarray(catalog.get_num_records(), dtype=np.float64)
    tiles_per_patch = np.maximum(1.0, counts / tile_size)
    radius_spatial = catalog.patch_radii / np.sqrt(tiles_per_patch)
    radius_zmajor = np.median(radius_spatial) * np.sqrt(num_bins)
    return "zmajor" if max_angle >= radius_zmajor else "spatial"


def morton_codes(xyz: NDArray, bits: int = 10) -> NDArray:
    """Interleaved-bit (Morton) codes for 3D points in ``[-1, 1]^3``.

    Sorting by these codes groups spatial neighbours, which keeps the
    bounding caps of consecutive point tiles compact.
    """
    if _native.enabled():
        return _native.morton_codes(np.asarray(xyz, np.float64), bits)

    quantised = np.clip(
        ((xyz + 1.0) * (0.5 * (1 << bits))).astype(np.int64), 0, (1 << bits) - 1
    )
    codes = np.zeros(len(xyz), dtype=np.int64)
    for bit in range(bits):
        for dim in range(3):
            codes |= ((quantised[:, dim] >> bit) & 1) << (3 * bit + dim)
    return codes


def _pack_numpy(xyz, pair_weights, zbins, dest, num_tiles, tile_size):
    """Numpy fallback for the packed-layout scatter."""
    lane_data = np.zeros((num_tiles, NUM_CHANNELS, tile_size), np.float32)
    tiles = dest // tile_size
    lanes = dest - tiles * tile_size
    hi = xyz.astype(np.float32)
    lo = (xyz - hi.astype(np.float64)).astype(np.float32)
    for dim in range(3):
        lane_data[tiles, dim, lanes] = hi[:, dim]
        lane_data[tiles, 3 + dim, lanes] = lo[:, dim]
    lane_data[tiles, CHANNEL_WEIGHT, lanes] = pair_weights.astype(np.float32)
    lane_data[tiles, CHANNEL_ZBIN, lanes] = zbins.astype(np.float32)
    return lane_data


def _caps_numpy(xyz, dest, num_tiles, tile_size):
    """Numpy fallback for the tile bounding caps."""
    tiles = dest // tile_size
    sums = np.zeros((num_tiles, 3))
    for dim in range(3):
        sums[:, dim] = np.bincount(
            tiles, weights=xyz[:, dim], minlength=num_tiles
        )
    norms = np.linalg.norm(sums, axis=1)
    centers = np.zeros((num_tiles, 3))
    centers[:, 0] = 1.0
    nonempty = norms > 0
    centers[nonempty] = sums[nonempty] / norms[nonempty, None]

    chord = np.linalg.norm(xyz - centers[tiles], axis=1)
    max_chord = np.zeros(num_tiles)
    np.maximum.at(max_chord, tiles, chord)
    return centers, max_chord


@dataclass(eq=False)  # identity semantics: field-wise eq over numpy arrays
# is ambiguous anyway, and identity hashing lets weakrefs key the pair-list
# memo (ops/linkage.py)
class TileSet:
    """A catalog packed into fixed-size point tiles for the pair-count engine.

    Attributes:
        lane_data:
            float32 array ``(num_tiles, 8, tile_size)``; channel layout is
            ``[x_hi, y_hi, z_hi, x_lo, y_lo, z_lo, weight, zbin]``.
        tile_patch:
            Patch id of each tile (every tile belongs to exactly one patch).
        tile_center:
            Unit-sphere bounding-cap centers, float64 ``(num_tiles, 3)``.
        tile_radius:
            Bounding-cap opening angles in radian, float64 ``(num_tiles,)``.
        patch_tile_start / patch_tile_stop:
            Per-patch [start, stop) ranges into the tile arrays.
        sum_weights:
            Per (bin, patch) sum of pair weights, float64 ``(B, P)`` —
            the normalisation input. For unbinned tile sets ``B == 1``.
        sum_kappa:
            Per (bin, patch) weighted sum of the scalar field (None if the
            catalog has no kappa values).
        tile_zmin / tile_zmax:
            Per-tile redshift-bin index range (inclusive). Points are
            sorted by bin within each patch, so tiles are bin-coherent and
            the range enables per-tile angular-cutoff pruning in
            :func:`~yet_another_wizz_tpu_torch.ops.linkage.build_tile_pairs`.
            Unbinned tile sets carry zeros; tiles without points carry the
            empty range ``(0, -1)``.
        num_bins:
            Number of redshift bins (0 for an unbinned tile set).
        num_points:
            Number of (non-padding) points retained in the tiles.
    """

    lane_data: NDArray
    tile_patch: NDArray
    tile_center: NDArray
    tile_radius: NDArray
    patch_tile_start: NDArray
    patch_tile_stop: NDArray
    sum_weights: NDArray
    sum_kappa: NDArray | None
    tile_zmin: NDArray
    tile_zmax: NDArray
    num_bins: int
    num_points: int
    tile_size: int = DEFAULT_TILE_SIZE
    _device_lanes: dict = field(default_factory=dict, repr=False)
    """The uploaded ``lane_data`` per torch device, and its shards per
    (device, num_shards, index) (see :meth:`device_data`)."""
    _upload_lock: object = field(
        default_factory=threading.Lock, repr=False, compare=False
    )
    _pair_memo: object = field(default=None, repr=False, compare=False)
    """Per-tile-set LRU of pruned tile-pair lists, populated and bounded by
    :func:`yet_another_wizz_tpu_torch.ops.linkage.build_tile_pairs` (keyed
    on the column tile set + linkage inputs). Lives on the ROW tile set so
    the memo is dropped with its catalog's tile cache."""

    def device_data(
        self,
        device: torch.device | str,
        *,
        stream: torch.cuda.Stream | None = None,
        shard: tuple[int, int] | None = None,
    ) -> torch.Tensor:
        """``lane_data`` as a float32 ``(num_tiles, 8, tile_size)`` tensor
        on ``device``, uploaded once per device and cached: repeated
        engine calls must not re-transfer the catalog. With ``shard =
        (num_shards, index)`` only the tiles of :func:`shard_bounds` are
        uploaded, cached per device, ``num_shards`` and ``index`` (the
        column and ring layouts of the sharded engine).

        To a CUDA device the lanes are copied from pinned host memory
        without blocking, on ``stream`` (a side stream, e.g. of a prefetch
        worker) or else on the current stream. A later call on another
        stream makes that stream wait for the copy and marks the lanes as
        used by it (``record_stream``), so their memory is not reused while
        kernels queued there still read them, whenever the tile set drops
        them. Each call counts a hit or a miss of the cache
        (``cache.hit.lanes``, ``cache.miss.lanes``)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = device if shard is None else (device, *shard)
        with self._upload_lock:
            upload = self._device_lanes.get(key)
            count("cache.miss.lanes" if upload is None else "cache.hit.lanes")
            if upload is None:
                lanes = self.lane_data
                if shard is not None:
                    lo, hi = shard_bounds(self.num_tiles, *shard)
                    lanes = lanes[lo:hi]
                upload = _Upload(lanes, device, stream)
                self._device_lanes[key] = upload
            if stream is None:
                upload.consume_on_current_stream()
        return upload.lanes

    def device_upload(self, device: torch.device | str):
        """The CUDA events recorded on the copy's stream just before and
        just after the lanes were copied to ``device`` (one tuple object per
        upload), or None when they are not on it or it is not a CUDA
        device."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        upload = self._device_lanes.get(device)
        return None if upload is None else upload.events

    def drop_device_data(self) -> None:
        """Release the uploaded lanes and shards of lanes (and with them the
        chunk caps the kernels derived from them) on every device; they are
        uploaded again on the next :meth:`device_data`."""
        with self._upload_lock:
            self._device_lanes.clear()

    @property
    def num_tiles(self) -> int:
        return len(self.tile_patch)

    @property
    def num_patches(self) -> int:
        return len(self.patch_tile_start)

    @property
    def binned(self) -> bool:
        return self.num_bins > 0

    def patch_tiles(self, patch_id: int) -> NDArray:
        """Indices of the tiles belonging to one patch."""
        return np.arange(
            self.patch_tile_start[patch_id], self.patch_tile_stop[patch_id]
        )

    def bin_sum_weights(self, num_bins: int) -> NDArray:
        """Per (bin, patch) sum of weights broadcast to ``num_bins`` bins
        (unbinned tile sets contribute the same total to every bin)."""
        if self.binned:
            if num_bins != self.num_bins:
                raise ValueError("number of bins does not match tile set")
            return self.sum_weights
        return np.broadcast_to(
            self.sum_weights, (num_bins, self.num_patches)
        ).copy()


class _Upload:
    """The lanes of a tile set on one device; on a CUDA device also the
    stream their copy was queued on, CUDA events before and after the copy,
    and the streams that have waited for it."""

    __slots__ = ("lanes", "stream", "events", "consumers")

    def __init__(self, lane_data: NDArray, device: torch.device, stream) -> None:
        self.stream = self.events = None
        self.consumers: set = set()
        if device.type != "cuda":
            self.lanes = torch.from_numpy(lane_data).to(device)
            return
        host = torch.from_numpy(lane_data).pin_memory()
        self.stream = stream or torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self.stream):
            start.record(self.stream)
            # the pinned block stays reserved until the copy is done
            self.lanes = host.to(device, non_blocking=True)
            done.record(self.stream)
        self.events = (start, done)
        self.consumers.add(self.stream)

    def consume_on_current_stream(self) -> None:
        if self.stream is None:
            return
        current = torch.cuda.current_stream(self.lanes.device)
        if current not in self.consumers:
            current.wait_event(self.events[1])
            self.lanes.record_stream(current)
            self.consumers.add(current)


def build_tile_set(
    xyz: NDArray,
    patch_ids: NDArray,
    num_patches: int,
    *,
    weights: NDArray | None = None,
    zbins: NDArray | None = None,
    num_bins: int = 0,
    kappa: NDArray | None = None,
    tile_size: int = DEFAULT_TILE_SIZE,
    mode_weights: NDArray | None = None,
    layout: str = "spatial",
) -> TileSet:
    """Build a :class:`TileSet` from per-point arrays.

    Args:
        xyz: float64 unit-sphere positions, shape ``(N, 3)``.
        patch_ids: integer patch assignment per point.
        num_patches: total number of patches (patches may be empty).
        weights: optional per-point weights (default 1); used for the
            ``sum_weights`` normalisation.
        zbins: per-point redshift-bin index in ``[0, num_bins)``; points
            outside the binning (negative or >= num_bins) are dropped,
            mirroring the reference where out-of-range points enter no tree.
        num_bins: number of redshift bins (0 = unbinned).
        kappa: optional per-point scalar field values.
        tile_size: points per tile.
        mode_weights: pair weights actually written to the weight channel
            (e.g. ``kappa * weights`` for scalar counting modes); defaults
            to ``weights``.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    n = len(xyz)
    patch_ids = np.asarray(patch_ids)
    weights = (
        np.ones(n, dtype=np.float64)
        if weights is None
        else np.asarray(weights, dtype=np.float64)
    )
    pair_weights = (
        weights if mode_weights is None else np.asarray(mode_weights, np.float64)
    )

    if zbins is not None and num_bins > 0:
        zbins = np.asarray(zbins)
        keep = (zbins >= 0) & (zbins < num_bins)
        xyz, patch_ids, weights = xyz[keep], patch_ids[keep], weights[keep]
        pair_weights = pair_weights[keep]
        zbins = zbins[keep].astype(np.float64)
        kappa = kappa[keep] if kappa is not None else None
    else:
        num_bins = 0
        zbins = np.zeros(len(xyz), dtype=np.float64)

    # sort: group by patch, Morton-order within ("spatial"), optionally by
    # redshift bin first ("zmajor": Morton within each (patch, bin)).
    # zmajor makes tiles bin-coherent — enabling per-tile angular-cutoff
    # pruning and disjoint-bin dropping in the linkage — at the cost of
    # inflating tile bounding caps by ~sqrt(num_bins) (a redshift slice
    # spreads over the whole patch footprint). Callers choose zmajor only
    # when the angular cutoff dominates the cap radii (see
    # correlation.measurements._prefer_zmajor_layout).
    if layout not in ("spatial", "zmajor"):
        raise ValueError(f"unknown tile layout '{layout}'")
    use_zbin_key = layout == "zmajor" and num_bins > 0
    if (
        _native.enabled()
        and len(xyz)
        and num_patches < 2**15  # patch field of the composite sort key
        and num_bins < 2**16  # zbin field (int16 bin-lane bound)
    ):
        # one parallel radix argsort over a composite (patch, zbin,
        # morton) uint64 key plus parallel permutation gathers — the
        # block-packing hot path of the out-of-core loop, where
        # np.lexsort's three stable single-threaded passes and the five
        # fancy-index copies dominated the build wall
        shared_pair_weights = pair_weights is weights
        order = _native.sort_order(
            np.ascontiguousarray(patch_ids, np.int32),
            zbins.astype(np.int32) if use_zbin_key else None,
            morton_codes(xyz),
        )
        xyz = _native.gather_f64(xyz, order)
        patch_ids = _native.gather_i32(patch_ids, order)
        weights = _native.gather_f64(weights, order)
        pair_weights = (
            weights
            if shared_pair_weights
            else _native.gather_f64(pair_weights, order)
        )
        zbins = _native.gather_f64(zbins, order)
        kappa = _native.gather_f64(kappa, order) if kappa is not None else None
    else:
        if use_zbin_key:
            order = np.lexsort((morton_codes(xyz), zbins, patch_ids))
        else:
            order = np.lexsort((morton_codes(xyz), patch_ids))
        xyz = np.ascontiguousarray(xyz[order])
        patch_ids = patch_ids[order]
        weights = weights[order]
        pair_weights = pair_weights[order]
        zbins = zbins[order]
        kappa = kappa[order] if kappa is not None else None

    counts = np.bincount(patch_ids, minlength=num_patches)
    tiles_per_patch = np.maximum(1, -(-counts // tile_size))  # >=1 tile/patch
    patch_tile_stop = np.cumsum(tiles_per_patch)
    patch_tile_start = patch_tile_stop - tiles_per_patch
    num_tiles = int(patch_tile_stop[-1]) if num_patches else 0

    # destination of each (sorted) point in the padded global layout
    patch_offsets = np.concatenate([[0], np.cumsum(counts)])[:-1]
    position_in_patch = np.arange(len(xyz)) - patch_offsets[patch_ids]
    dest = (
        patch_tile_start[patch_ids].astype(np.int64) * tile_size
        + position_in_patch
    )

    if _native.enabled():
        lane_data = _native.pack_tiles(
            xyz, pair_weights, zbins, dest, num_tiles, tile_size
        )
        tile_center, max_chord = _native.tile_caps(
            xyz, dest, num_tiles, tile_size
        )
    else:
        lane_data = _pack_numpy(
            xyz, pair_weights, zbins, dest, num_tiles, tile_size
        )
        tile_center, max_chord = _caps_numpy(xyz, dest, num_tiles, tile_size)
    tile_radius = chord_to_angle(max_chord)

    # padding rows exist only in the last tile of each patch; park them on
    # the tile center so cap pruning stays tight (weights are already zero)
    for pid in np.nonzero(counts % tile_size)[0]:
        last_tile = patch_tile_stop[pid] - 1
        fill = counts[pid] - (tiles_per_patch[pid] - 1) * tile_size
        lane_data[last_tile, 0:3, fill:] = (
            tile_center[last_tile].astype(np.float32)[:, None]
        )
    for pid in np.nonzero(counts == 0)[0]:
        lane_data[patch_tile_start[pid], 0, :] = 1.0

    # per-tile redshift-bin ranges: dest is nondecreasing row-wise, so each
    # tile is a contiguous row segment; reduce bin min/max per segment
    tile_zmin = np.zeros(num_tiles, dtype=np.int32)
    tile_zmax = np.zeros(num_tiles, dtype=np.int32)
    if num_bins > 0 and len(xyz) and num_tiles:
        tile_idx = dest // tile_size
        tile_range = np.arange(num_tiles)
        starts = np.searchsorted(tile_idx, tile_range, side="left")
        stops = np.searchsorted(tile_idx, tile_range, side="right")
        zb = zbins.astype(np.int32)
        has_rows = stops > starts
        # reduceat only over non-empty tiles: their starts are strictly
        # increasing and < len(zb), and each segment runs to the next
        # non-empty tile's start (empty tiles in between hold no rows).
        # Clipping empty trailing starts into range instead would truncate
        # the last non-empty tile's segment, silently dropping its final
        # point's bin from the range used for pair pruning.
        tile_zmax = np.full(num_tiles, -1, dtype=np.int32)  # empty: never links
        tile_zmin = np.zeros(num_tiles, dtype=np.int32)
        nonempty = np.nonzero(has_rows)[0]
        if len(nonempty):
            tile_zmin[nonempty] = np.minimum.reduceat(zb, starts[nonempty])
            tile_zmax[nonempty] = np.maximum.reduceat(zb, starts[nonempty])

    # per (bin, patch) normalisation sums in float64
    effective_bins = max(num_bins, 1)
    flat_idx = zbins.astype(np.int64) * num_patches + patch_ids
    sum_weights = np.bincount(
        flat_idx, weights=weights, minlength=effective_bins * num_patches
    ).reshape(effective_bins, num_patches)
    sum_kappa = None
    if kappa is not None:
        sum_kappa = np.bincount(
            flat_idx, weights=kappa * weights,
            minlength=effective_bins * num_patches,
        ).reshape(effective_bins, num_patches)

    return TileSet(
        lane_data=lane_data,
        tile_patch=np.repeat(np.arange(num_patches), tiles_per_patch),
        tile_center=tile_center,
        tile_radius=tile_radius,
        patch_tile_start=patch_tile_start,
        patch_tile_stop=patch_tile_stop,
        sum_weights=sum_weights,
        sum_kappa=sum_kappa,
        tile_zmin=tile_zmin,
        tile_zmax=tile_zmax,
        num_bins=num_bins,
        num_points=len(xyz),
        tile_size=tile_size,
    )

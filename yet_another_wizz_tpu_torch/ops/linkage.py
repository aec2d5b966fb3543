"""Patch- and tile-level pair pruning by bounding caps.

The reference prunes the O(P^2) patch-pair grid with an angular cutoff
(yaw/correlation/measurements.py:171-237) and relies on
the kd-tree's internal node bounds for finer pruning. Here the same cutoff
is applied twice: once per patch pair, and again per *tile* pair using the
tile bounding caps from :mod:`yet_another_wizz_tpu_torch.ops.tiles` — recovering
the dual-tree's work complexity at tile granularity while keeping all
shapes static for the device kernel.

The resulting flat tile-pair list (sorted by patch-pair slot) is the grid
the pair-count kernel iterates over, and the unit of sharding across
devices.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from numpy.typing import NDArray

    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "Linkage",
    "TilePairs",
    "build_linkage",
    "build_tile_pairs",
]


def _cap_distances(centers1: NDArray, centers2: NDArray) -> NDArray:
    """Pairwise angular distances between two sets of unit vectors,
    computed in float64 via the chord."""
    # (n1, n2) chord matrix; inputs are small metadata arrays
    dots = np.clip(centers1 @ centers2.T, -1.0, 1.0)
    return 2.0 * np.arcsin(np.sqrt(np.maximum(0.5 * (1.0 - dots), 0.0)))


@dataclass
class Linkage:
    """Which patch pairs are close enough to contain pairs below the maximum
    angular scale.

    Attributes:
        max_angle: the angular cutoff in radian.
        linked: boolean matrix ``(P, P)``; entry (i, j) is True if patches i
            and j are separated by less than ``r_i + r_j + max_angle``.
    """

    max_angle: float
    linked: NDArray

    @property
    def num_patches(self) -> int:
        return len(self.linked)

    @property
    def num_links(self) -> int:
        """Number of linked (ordered) patch pairs."""
        return int(self.linked.sum())

    @property
    def density(self) -> float:
        """Fraction of all ordered patch pairs that are linked."""
        return self.num_links / self.linked.size

    def patch_pairs(self, *, auto: bool) -> NDArray:
        """Linked patch-pair ids as an ``(n_pairs, 2)`` array.

        For autocorrelations only pairs with ``id2 >= id1`` are returned
        (the unordered half of the grid; equal-id pairs are counted twice by
        the engine and halved downstream, mirroring the reference).
        """
        id1, id2 = np.nonzero(self.linked)
        if auto:
            keep = id2 >= id1
            id1, id2 = id1[keep], id2[keep]
        return np.column_stack([id1, id2])


def build_linkage(
    patch_centers: NDArray,
    patch_radii: NDArray,
    max_angle: float,
) -> Linkage:
    """Compute the patch linkage from patch cap centers (unit vectors),
    cap radii (radian) and the maximum angular separation of the
    measurement."""
    distances = _cap_distances(patch_centers, patch_centers)
    cutoff = patch_radii[:, None] + patch_radii[None, :] + max_angle
    return Linkage(max_angle=float(max_angle), linked=distances < cutoff)


@dataclass
class TilePairs:
    """A flat, slot-sorted list of tile pairs to feed the pair-count engine.

    Attributes:
        tile1, tile2: tile indices into the two tile sets.
        slot: patch-pair slot index of each tile pair.
        slot_patches: ``(num_slots, 2)`` patch ids per slot.
    """

    tile1: NDArray
    tile2: NDArray
    slot: NDArray
    slot_patches: NDArray
    _device_cache: dict = field(
        default_factory=dict, repr=False, compare=False
    )
    """Engine-side derived inputs keyed by device (the index tensors and
    slot run offsets of :func:`_pair_index`). Populated by the engines so
    repeated counts over a memoised pair list skip rebuilding AND
    re-uploading their index lists (see :func:`build_tile_pairs`); the
    device tensors are freed with the pair list."""

    @property
    def num_pairs(self) -> int:
        return len(self.tile1)

    @property
    def num_slots(self) -> int:
        return len(self.slot_patches)


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
    """The index tensors and slot run offsets of ``pairs`` on ``device``
    that both engines read, computed once and cached on the pair list."""
    key = ("pair_index", device)
    index = pairs._device_cache.get(key)
    if index is None:
        count("cache.miss.pair_index")
        index = _PairIndex(pairs, device)
        pairs._device_cache[key] = index
    else:
        count("cache.hit.pair_index")
    return index


MAX_CANDIDATE_CHUNK = 8_000_000
"""Upper bound on simultaneously materialised tile-pair candidates in
:func:`build_tile_pairs` (~0.8 GB of temporaries); whole slots are
grouped under this bound, so typical survey problems still run in one
vectorised pass."""

FILTER_MARGIN = 1e-12
"""Conservative slack on the cosine-form cap test (`kFilterMargin` in
tilepack.cpp must match): the tile-pair filter is a PRUNE, so admitting a
boundary-ulp pair costs a little compute while dropping one could lose
counted point pairs in degenerate tangent configurations. 1e-12 on the
cosine dwarfs the bound formula's ~1e-15 rounding yet admits only pairs
within ~1e-6 rad of the exact boundary."""


def _bin_range_max(bin_max_angles: NDArray) -> NDArray:
    """``(B, B)`` table of ``max(bin_max_angles[a..b])`` for bin ranges.

    A small relative margin keeps pairs whose float32-rounded squared
    chord could still classify into the outermost interval in the kernel.
    """
    num_bins = len(bin_max_angles)
    table = np.zeros((num_bins, num_bins))
    for a in range(num_bins):
        table[a, a:] = np.maximum.accumulate(bin_max_angles[a:])
    return table * (1.0 + 1e-5)


_PAIR_MEMO_SIZE = 8
"""Per-row-tile-set LRU capacity of the pair-list memo: bounds both the
host index arrays and the device-resident stacked uploads retained per
:class:`TileSet` (typical entries are a few MB; the memo exists for the
warm-repeat and shared-row/column patterns, which revisit only a handful
of distinct keys)."""

_pair_memo_lock = threading.Lock()


def _pair_memo_enabled() -> bool:
    """The memo is on by default; ``YAWT_PAIR_MEMO=0`` (or any
    conventional negative spelling) disables it. Evaluated per call so
    tests can toggle the flag without reloading the module."""
    import os

    raw = os.environ.get("YAWT_PAIR_MEMO")
    if raw is None:
        return True
    return raw.strip().lower() not in ("", "0", "false", "no", "off", "n")


def _drop_pair_memo_entry(tiles1_ref, key) -> None:
    """Weakref-finalizer hook: evict a memo entry eagerly when its column
    tile set is garbage collected (e.g. the blocked path's resident-tile
    layer dropping a column block), instead of waiting for LRU pressure."""
    tiles1 = tiles1_ref()
    if tiles1 is None:
        return
    memo = getattr(tiles1, "_pair_memo", None)
    if memo is None:
        return
    # finalizers run wherever garbage collection happens to trigger —
    # including during allocations INSIDE a locked memo operation on the
    # same thread. The lock is not reentrant, so never block here: a
    # missed eager eviction just leaves the (weakly small) entry to LRU
    # pressure.
    if not _pair_memo_lock.acquire(blocking=False):
        return
    try:
        memo.pop(key, None)
    finally:
        _pair_memo_lock.release()


def build_tile_pairs(
    tiles1: TileSet,
    tiles2: TileSet,
    linkage: Linkage,
    *,
    auto: bool,
    bin_max_angles: NDArray | None = None,
) -> TilePairs:
    """Enumerate tile pairs for all linked patch pairs, pruned by tile caps
    (memoised — see below).

    Tile sets are immutable once built and cached on their catalog
    (:meth:`Catalog.get_tiles`), so the pruned pair list is fully
    determined by the two tile-set identities plus the linkage content and
    cutoff inputs. A small per-``tiles1`` LRU keyed on exactly those
    inputs makes repeated counts over the same catalogs — warm
    re-measurements, tomographic runs over a shared reference sample, and
    the blocked path's DD/DR counts revisiting the same row/column block
    pairs — reuse one :class:`TilePairs` object, which in turn lets the
    engines reuse its device-resident index upload
    (``TilePairs._device_cache``). Set ``YAWT_PAIR_MEMO=0`` to disable.
    Each call counts a hit or a miss of the memo (``cache.hit.pairs``,
    ``cache.miss.pairs``).
    """
    if not _pair_memo_enabled():
        count("cache.miss.pairs")
        return _build_tile_pairs(
            tiles1, tiles2, linkage, auto=auto, bin_max_angles=bin_max_angles
        )

    bma_key = (
        None
        if bin_max_angles is None
        else np.asarray(bin_max_angles, np.float64).tobytes()
    )
    key = (
        weakref.ref(tiles2),
        linkage.linked.shape,
        linkage.linked.tobytes(),
        float(linkage.max_angle),
        bool(auto),
        bma_key,
    )
    with _pair_memo_lock:
        memo = getattr(tiles1, "_pair_memo", None)
        if memo is None:
            memo = OrderedDict()
            object.__setattr__(tiles1, "_pair_memo", memo)
        hit = memo.get(key)
        if hit is not None:
            memo.move_to_end(key)
            count("cache.hit.pairs")
            return hit

    count("cache.miss.pairs")
    result = _build_tile_pairs(
        tiles1, tiles2, linkage, auto=auto, bin_max_angles=bin_max_angles
    )

    with _pair_memo_lock:
        memo[key] = result
        memo.move_to_end(key)
        while len(memo) > _PAIR_MEMO_SIZE:
            memo.popitem(last=False)
    if tiles2 is not tiles1:
        weakref.finalize(
            tiles2, _drop_pair_memo_entry, weakref.ref(tiles1), key
        )
    return result


def _build_tile_pairs(
    tiles1: TileSet,
    tiles2: TileSet,
    linkage: Linkage,
    *,
    auto: bool,
    bin_max_angles: NDArray | None = None,
) -> TilePairs:
    """Enumerate tile pairs for all linked patch pairs, pruned by tile caps.

    For ``auto`` measurements only patch pairs with ``id2 >= id1`` are
    generated; tile pairs within those patch pairs cover the full ordered
    tile grid (the double counting matches the reference's same-patch
    handling and is corrected downstream).

    With ``bin_max_angles`` (per-redshift-bin maximum angular edge) and a
    binned row tile set, the cutoff is evaluated per tile pair from the
    tiles' bin ranges instead of the global maximum: physical/comoving
    scales shrink with redshift, so high-redshift tiles link far fewer
    neighbours. When both sides are binned (autocorrelation-style counting
    requires equal bins) tile pairs with disjoint bin ranges are dropped
    outright. This recovers the per-bin pruning the reference gets from
    querying each redshift slice's kd-tree separately with its own radius
    (yaw/catalog/trees.py:303-362).
    """
    pairs = linkage.patch_pairs(auto=auto)
    cutoff_angle = linkage.max_angle

    per_tile_cutoff = bin_max_angles is not None and tiles1.binned
    if per_tile_cutoff:
        range_max = _bin_range_max(np.asarray(bin_max_angles, np.float64))

    if len(pairs) == 0:
        empty = np.empty(0, dtype=np.int32)
        return TilePairs(
            tile1=empty, tile2=empty, slot=empty, slot_patches=pairs
        )

    # fully vectorised candidate enumeration (one python loop per SLOT
    # was the dominant host cost at high patch counts): every linked
    # patch pair contributes its dense (tiles-in-p1 x tiles-in-p2) grid,
    # flattened row-major so the surviving order matches the historical
    # per-slot np.nonzero order exactly (slot-sorted, row-tile-major).
    # Slots are processed in groups whose cumulative candidate count is
    # bounded: materialising ALL candidates at once costs ~100 B each in
    # temporaries, which at survey scale (1e8+ unpruned grid entries)
    # would blow up peak host memory where the old loop was negligible.
    p1 = pairs[:, 0]
    p2 = pairs[:, 1]
    start1 = tiles1.patch_tile_start[p1].astype(np.int64)
    start2 = tiles2.patch_tile_start[p2].astype(np.int64)
    n1 = (tiles1.patch_tile_stop[p1] - tiles1.patch_tile_start[p1]).astype(
        np.int64
    )
    n2 = (tiles2.patch_tile_stop[p2] - tiles2.patch_tile_start[p2]).astype(
        np.int64
    )
    # native streaming filter: identical predicate evaluated slot by slot
    # in C++ (two passes: size, then fill) — no candidate-grid
    # temporaries at all, ~8x the numpy group pass on one core (the
    # numpy path is the dominant host cost of a 40M-row blocked run)
    from yet_another_wizz_tpu_torch import _native

    if _native.enabled():
        kwargs = {}
        if per_tile_cutoff:
            kwargs.update(
                per_tile=2 if tiles2.binned else 1,
                zmin1=tiles1.tile_zmin,
                zmax1=tiles1.tile_zmax,
                range_max=range_max,
            )
            if tiles2.binned:
                kwargs.update(
                    zmin2=tiles2.tile_zmin, zmax2=tiles2.tile_zmax
                )
        else:
            kwargs.update(cutoff_angle=cutoff_angle)
        tile1, tile2, slot = _native.filter_tile_pairs(
            start1, start2, n1, n2,
            tiles1.tile_center, tiles1.tile_radius,
            tiles2.tile_center, tiles2.tile_radius,
            **kwargs,
        )
        return TilePairs(
            tile1=tile1, tile2=tile2, slot=slot, slot_patches=pairs
        )

    # per-tile trig for the cosine-form cap test, computed once per call
    # (the native wrapper computes the identical arrays for its kernel)
    cos_r1 = np.cos(tiles1.tile_radius)
    sin_r1 = np.sin(tiles1.tile_radius)
    cos_r2 = np.cos(tiles2.tile_radius)
    sin_r2 = np.sin(tiles2.tile_radius)
    if per_tile_cutoff:
        cos_range = np.cos(range_max)
        sin_range = np.sin(range_max)
    else:
        cos_cutoff = float(np.cos(cutoff_angle))
        sin_cutoff = float(np.sin(cutoff_angle))

    sizes = n1 * n2
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    num_slots = len(pairs)
    # greedy slot grouping under the candidate bound (one iteration per
    # GROUP; a single slot larger than the bound forms its own group)
    group_edges = [0]
    while group_edges[-1] < num_slots:
        cut = int(
            np.searchsorted(
                bounds,
                bounds[group_edges[-1]] + MAX_CANDIDATE_CHUNK,
                side="right",
            )
            - 1
        )
        group_edges.append(min(max(cut, group_edges[-1] + 1), num_slots))

    kept1, kept2, kept_slot = [], [], []
    for g_lo, g_hi in zip(group_edges[:-1], group_edges[1:]):
        if g_hi <= g_lo:
            continue
        g_sizes = sizes[g_lo:g_hi]
        total = int(g_sizes.sum())
        if total == 0:
            continue
        slot_of = g_lo + np.repeat(
            np.arange(g_hi - g_lo, dtype=np.int64), g_sizes
        )
        k = np.arange(total, dtype=np.int64) - (
            bounds[slot_of] - bounds[g_lo]
        )
        n2_r = n2[slot_of]
        cand1 = start1[slot_of] + k // n2_r
        cand2 = start2[slot_of] + k % n2_r

        # angular cap cut over the group's candidates at once, in COSINE
        # form (cos is strictly decreasing on [0, pi] and cos(dist) is
        # the dot product itself, so `dist < r1 + r2 + theta` becomes
        # `dot > cos(r1 + r2 + theta)` — no arcsin/sqrt per candidate).
        # The bound expands through the per-tile trig computed once
        # above; operation order matches tilepack.cpp exactly so the
        # native path reproduces this kept set bit for bit. Angle sums
        # >= pi always link (cos wraps), and the shared margin absorbs
        # last-ulp rounding — the filter is a prune, so admitting a
        # boundary-ulp pair is free while dropping one is not.
        c1 = tiles1.tile_center[cand1]
        c2 = tiles2.tile_center[cand2]
        dots = (
            c1[:, 0] * c2[:, 0] + c1[:, 1] * c2[:, 1] + c1[:, 2] * c2[:, 2]
        )
        cr1 = cos_r1[cand1]
        sr1 = sin_r1[cand1]
        cr2 = cos_r2[cand2]
        sr2 = sin_r2[cand2]
        ca = cr1 * cr2 - sr1 * sr2  # cos(r1 + r2)
        sa = sr1 * cr2 + cr1 * sr2  # sin(r1 + r2)
        radii = tiles1.tile_radius[cand1] + tiles2.tile_radius[cand2]
        if per_tile_cutoff:
            zmin1 = tiles1.tile_zmin[cand1]
            zmax1 = tiles1.tile_zmax[cand1]
            if tiles2.binned:
                # equal-bin counting: only the overlapping range matters
                lo = np.maximum(zmin1, tiles2.tile_zmin[cand2])
                hi = np.minimum(zmax1, tiles2.tile_zmax[cand2])
                valid = lo <= hi
                at = (np.minimum(lo, hi), np.maximum(hi, 0))
            else:
                valid = zmax1 >= zmin1
                at = (
                    np.minimum(zmin1, np.maximum(zmax1, 0)),
                    np.maximum(zmax1, 0),
                )
            theta = range_max[at]
            bound = ca * cos_range[at] - sa * sin_range[at]
            keep = (
                (dots > bound - FILTER_MARGIN) | (radii + theta >= np.pi)
            ) & valid
        else:
            bound = ca * cos_cutoff - sa * sin_cutoff
            keep = (dots > bound - FILTER_MARGIN) | (
                radii + cutoff_angle >= np.pi
            )
        kept1.append(cand1[keep].astype(np.int32))
        kept2.append(cand2[keep].astype(np.int32))
        kept_slot.append(slot_of[keep].astype(np.int32))

    if kept1:
        tile1 = np.concatenate(kept1)
        tile2 = np.concatenate(kept2)
        slot = np.concatenate(kept_slot)
    else:
        tile1 = tile2 = slot = np.empty(0, dtype=np.int32)
    return TilePairs(
        tile1=tile1, tile2=tile2, slot=slot, slot_patches=pairs
    )

"""Device-memory-bounded pair counting over patch blocks.

Ported from the JAX package's ``correlation/blocked.py``. At survey scale
the packed tile arrays of a catalog, and at the largest scales its rows on
the host, exceed what one process should hold. The blocked path streams
the measurement through the device in patch blocks:

- patches are processed in contiguous blocks of ``max_resident_patches //
  2`` (two resident sides);
- for every linked pair of blocks, tile sets are built for just those
  patches (``catalog.load_block``, so a disk-backed
  :class:`~yet_another_wizz_tpu_torch.catalog.lazy.LazyCatalog` keeps host
  memory bounded too) and pushed through the regular engine
  (:func:`~yet_another_wizz_tpu_torch.ops.paircount.count_pairs_tiles`, the
  CUDA kernels on a CUDA device);
- the per-block counts are reduced to scales and scattered into the global
  ``(scale, bin, patch, patch)`` result on the device (K2.3,
  :func:`scatter_block_scales`), or on the host with
  ``YAWT_DEVICE_ACCUMULATE=0``.

The engine output has exactly one zeroed row per patch-pair slot: the JAX
package's ``padded_slots`` contract (``ops/paircount.py:597`` there), with
its dump row P of the accumulator, has nothing to do here.

Enabled through ``max_resident_patches`` on the measurement functions.
With ``audit`` each block pair's count is audited (the engine's
``audit_boundary_counts``) and scattered on the host in float64. Under a
``mesh`` each block pair is counted sharded
(:func:`~yet_another_wizz_tpu_torch.parallel.count_pairs_sharded`), which
places the lanes per call: its counts are scattered on the host (K2.3 is
single-device) and the prefetch workers upload nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

import numpy as np
import torch

from yet_another_wizz_tpu_torch.catalog.tilestore import (
    TILE_SET_ARRAYS,
    PackedTileStore,
    tileset_from_payload,
    tileset_payload,
)
from yet_another_wizz_tpu_torch.ops.linkage import build_tile_pairs
from yet_another_wizz_tpu_torch.ops.paircount import (
    count_pairs_tiles,
    resolve_device,
)
from yet_another_wizz_tpu_torch.ops.tiles import (
    CAP_WIDTH,
    CHUNK_SIZE,
    DEFAULT_TILE_SIZE,
    NUM_CHANNELS,
    build_tile_set,
    preferred_tile_layout,
)
from yet_another_wizz_tpu_torch.parallel.sharded import resolve_mesh
from yet_another_wizz_tpu_torch.utils.tracing import count, span

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.binning import Binning
    from yet_another_wizz_tpu_torch.catalog.catalog import Catalog
    from yet_another_wizz_tpu_torch.ops.linkage import Linkage
    from yet_another_wizz_tpu_torch.ops.thresholds import AngularEdges
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "PIPELINE_DEPTH",
    "active_tile_cache",
    "count_pairs_blocked",
    "measurement_tile_cache",
    "scatter_block_scales",
]

logger = logging.getLogger(__name__)


def _build_block_tiles(
    catalog: Catalog,
    binning: Binning | None,
    mode: str,
    patch_lo: int,
    patch_hi: int,
    tile_size: int,
    layout: str = "spatial",
) -> TileSet:
    """Tile set for the patches in ``[patch_lo, patch_hi)`` with local
    patch indices, from ``catalog.load_block`` (the in-memory
    :class:`Catalog` and the disk-backed ``LazyCatalog`` alike)."""
    data = catalog.load_block(patch_lo, patch_hi)
    if mode == "k":
        if data.kappa is None:
            raise ValueError("missing required 'kappa' for scalar mode")
        mode_weights = (
            data.kappa if data.weights is None else data.kappa * data.weights
        )
    elif mode == "n":
        mode_weights = None
    else:
        # the in-memory Catalog.get_tiles validates the same way
        raise ValueError(f"invalid counting mode '{mode}'")

    if binning is None:
        zbins, num_bins = None, 0
    else:
        if data.redshifts is None:
            raise ValueError("catalog has no 'redshifts' attached")
        zbins = binning.digitize(data.redshifts) - 1
        num_bins = len(binning)

    return build_tile_set(
        data.xyz,
        data.patch_ids,
        patch_hi - patch_lo,
        weights=data.weights,
        zbins=zbins,
        num_bins=num_bins,
        kappa=data.kappa,
        tile_size=tile_size,
        mode_weights=mode_weights,
        layout=layout if binning is not None else "spatial",
    )


class _WeakId:
    """Hashable weak-identity token for cache keys.

    Catalogs are Mappings (unhashable), so ``weakref.ref`` cannot key a
    dict directly. Tokens of the same LIVE object compare equal (hash = the
    object's id); once the referent is garbage-collected a token only
    equals itself — a new object reusing the freed id hashes into the same
    bucket but never compares equal, so stale entries cannot be served and
    are reclaimed by :meth:`_ColumnTileCache._purge_dead`."""

    __slots__ = ("_ref", "_id")

    def __init__(self, obj) -> None:
        import weakref

        self._ref = weakref.ref(obj)
        self._id = id(obj)

    def __hash__(self) -> int:
        return self._id

    def __eq__(self, other) -> bool:
        if not isinstance(other, _WeakId):
            return NotImplemented
        mine, theirs = self._ref(), other._ref()
        if mine is None or theirs is None:
            return self._ref is other._ref
        return mine is theirs

    @property
    def dead(self) -> bool:
        return self._ref() is None


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


class _ColumnTileCache:
    """Per-measurement cache of packed column-block tile sets.

    The blocked loop sweeps every column block once per ROW block; without
    a cache each sweep re-reads the patch data, re-packs the tiles and
    re-uploads the lanes. Two bounded layers:

    - **resident** (``resident_bytes`` of budget, counted in device bytes:
      the lanes plus the chunk caps the cumulative kernel derives from
      them): the :class:`TileSet` objects themselves are kept alive, so
      their uploaded lanes (:meth:`TileSet.device_data`) stay on the card
      and every revisit skips both the packing and the upload. Host memory
      holds the same lane bytes, so the budget bounds both sides.
    - **disk spill**: blocks beyond the resident budget go to an
      uncompressed ``.npz`` per column block (capped at ``max_bytes``),
      turning a revisit into a sequential file read + one upload.

    Blocks beyond both budgets are rebuilt each sweep. Within one count,
    no eviction of its own entries: the sweep order revisits blocks
    uniformly, so evicting one block to admit another buys nothing. Across
    counts (generations, see :meth:`begin_count`) stale entries ARE evicted
    under budget pressure, oldest generation first, and an evicted
    resident entry drops its device lanes at once. Entries whose weakly
    keyed catalog has been freed can never be hit again and are purged
    eagerly (with their budget bytes and spill files). The cache lives for
    one :func:`count_pairs_blocked` call or, via
    :func:`measurement_tile_cache`, for a whole measurement, sharing blocks
    between its count types. Entries are keyed by ``(catalog, binning,
    mode, layout, block size, tile size, block index)``, so only
    identical tile sets are shared.

    ``store_rows=True`` (set by :func:`measurement_tile_cache`) also admits
    ROW blocks: within one count rows are visited once each, but across the
    counts of a measurement the same catalog often returns as the row side.

    Statistics: ``hits`` / ``misses`` of the lookups, ``evictions`` (stale
    resident entries dropped, with their device lanes, to admit another
    block), ``spills`` (blocks written to the disk layer) and
    ``spill_loads`` (blocks read back from it).
    """

    def __init__(
        self,
        directory: str | None,
        max_bytes: int,
        resident_bytes: int = 0,
        store_rows: bool = False,
    ) -> None:
        self._dir = directory
        self._max_bytes = max_bytes if directory is not None else 0
        self._used = 0
        self._paths: dict[object, tuple[str, int]] = {}
        self._resident_bytes = resident_bytes
        self._resident_used = 0
        self._resident: dict[object, TileSet] = {}
        self._stats_lock = threading.Lock()
        self._mutate_lock = threading.Lock()  # store/purge serialisation
        self._stored = 0  # monotonic: unique spill file names
        self.store_rows = store_rows
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.spills = 0
        self.spill_loads = 0
        self.generation = 0
        self._gen: dict[object, int] = {}  # last use per entry
        self._active: set[int] = set()  # generations of RUNNING counts

    def begin_count(self) -> int:
        """Mark the start of a new count (thread-safe); returns a token for
        :meth:`end_count`. Entries last used before the oldest still-RUNNING
        count began become evictable under budget pressure; entries touched
        since any running count began are never evicted."""
        with self._mutate_lock:
            self.generation += 1
            self._active.add(self.generation)
            self._purge_dead()
            return self.generation

    def end_count(self, token: int) -> None:
        """Retire a running count's generation (see :meth:`begin_count`)."""
        with self._mutate_lock:
            self._active.discard(token)

    def _eviction_floor(self) -> int:
        """Entries last used before this generation are evictable."""
        return min(self._active) if self._active else self.generation

    def _count(self, hit: bool) -> None:
        with self._stats_lock:  # loads run on prefetch threads
            if hit:
                self.hits += 1
            else:
                self.misses += 1

    def _drop_resident(self, key) -> None:
        """Remove a resident entry with its budget bytes and device lanes.
        Caller holds ``_mutate_lock``."""
        tiles = self._resident.pop(key)
        self._resident_used -= self._device_nbytes(tiles)
        self._gen.pop(key, None)
        tiles.drop_device_data()

    def _drop_spilled(self, key) -> None:
        """Remove a spilled entry with its budget bytes and file. Caller
        holds ``_mutate_lock``."""
        path, size = self._paths.pop(key)
        self._used -= size
        self._gen.pop(key, None)
        _unlink(path)

    def _evict_stale(self, resident: bool, needed: int) -> None:
        """Evict stale entries (oldest first, see :meth:`begin_count`) from
        one cache layer until ``needed`` bytes fit or none remain. Never
        evicts at all when ``needed`` cannot fit even after flushing EVERY
        stale entry. Caller holds ``_mutate_lock``."""
        if resident:
            layer, drop = self._resident, self._drop_resident

            def free() -> int:
                return self._resident_bytes - self._resident_used

            def size(key) -> int:
                return self._device_nbytes(layer[key])
        else:
            layer, drop = self._paths, self._drop_spilled

            def free() -> int:
                return self._max_bytes - self._used

            def size(key) -> int:
                return layer[key][1]

        floor = self._eviction_floor()
        stale = sorted(
            (key for key in layer if self._gen.get(key, 0) < floor),
            key=lambda key: self._gen.get(key, 0),
        )
        if free() + sum(size(key) for key in stale) < needed:
            return
        for key in stale:
            if free() >= needed:
                return
            drop(key)
            if resident:
                self.evictions += 1

    def _purge_dead(self) -> None:
        """Drop entries whose keyed catalog has been garbage-collected: a
        dead referent can never match a future lookup, so these entries are
        pure budget waste (device memory included). Caller holds
        ``_mutate_lock``."""

        def dead(key) -> bool:
            return isinstance(key[0], _WeakId) and key[0].dead

        for key in [k for k in self._resident if dead(k)]:
            self._drop_resident(key)
        for key in [k for k in self._paths if dead(k)]:
            self._drop_spilled(key)
        # load() stamps _gen outside _mutate_lock, so a stamp can land just
        # after an eviction popped the entry: sweep the orphans
        for key in [
            k for k in self._gen if k not in self._resident and k not in self._paths
        ]:
            del self._gen[key]

    @staticmethod
    def _device_nbytes(tiles: TileSet) -> int:
        """Device bytes of a tile set: the float32 lanes and the chunk caps
        the cumulative kernel derives from them."""
        per_tile = (
            NUM_CHANNELS * tiles.tile_size
            + tiles.tile_size // CHUNK_SIZE * CAP_WIDTH
        )
        return tiles.num_tiles * per_tile * 4

    def load(self, key, count: bool = True, resident_only: bool = False):
        """Fetch a cached tile set (None on miss). ``count=False`` leaves
        the hit/miss statistics alone (twin re-checks are bookkeeping, not
        packing work). ``resident_only=True`` skips the disk layer: a
        deserialization + re-upload is never cheaper than tiles the caller
        already holds."""
        tiles = self._resident.get(key)
        if tiles is not None:
            self._gen[key] = self.generation  # atomic dict write
            if count:
                self._count(hit=True)
            return tiles
        entry = None if resident_only else self._paths.get(key)
        if entry is None:
            if count:
                self._count(hit=False)
            return None
        try:
            with np.load(entry[0]) as payload:
                tiles = tileset_from_payload(payload)
        except FileNotFoundError:
            # a concurrent stale-eviction unlinked the spill between the
            # dict read and the open: a miss (the caller rebuilds)
            if count:
                self._count(hit=False)
            return None
        self._gen[key] = self.generation
        if count:
            self._count(hit=True)
        with self._stats_lock:
            self.spill_loads += 1
        # promote a disk hit into the resident layer when there is room
        with self._mutate_lock:
            if key in self._paths and self._admit_resident(key, tiles):
                path, size = self._paths.pop(key)
                self._used -= size
                _unlink(path)
        return tiles

    def store(self, key, tiles: TileSet) -> None:
        # one mutation at a time: an ambient cache may be shared by
        # concurrent measurements (user threads)
        with self._mutate_lock:
            self._store_locked(key, tiles)

    def _admit_resident(self, key, tiles: TileSet) -> bool:
        """Try to admit a tile set into the resident layer (evicting stale
        entries if required). Caller holds ``_mutate_lock``."""
        if key in self._resident:
            return False
        dev_size = self._device_nbytes(tiles)
        if self._resident_used + dev_size > self._resident_bytes:
            self._purge_dead()
            self._evict_stale(resident=True, needed=dev_size)
        if self._resident_used + dev_size <= self._resident_bytes:
            self._resident[key] = tiles
            self._resident_used += dev_size
            self._gen[key] = self.generation
            return True
        return False

    def _store_locked(self, key, tiles: TileSet) -> None:
        if key in self._resident or key in self._paths:
            # duplicate store (a prefetched row block that is also a column
            # block of an autocorrelation-shaped count): keep the first
            return
        if self._admit_resident(key, tiles):
            return
        if self._dir is None:
            return
        size = sum(getattr(tiles, name).nbytes for name in TILE_SET_ARRAYS)
        if tiles.sum_kappa is not None:
            size += tiles.sum_kappa.nbytes
        if self._used + size > self._max_bytes:
            self._evict_stale(resident=False, needed=size)
        if self._used + size > self._max_bytes:
            return
        self._stored += 1  # len(_paths) shrinks on purge: not name-safe
        path = os.path.join(self._dir, f"block_{self._stored}.npz")
        try:
            np.savez(path, **tileset_payload(tiles))
        except OSError as err:
            # a failed spill write (a full disk) degrades to an uncached
            # sweep instead of aborting the measurement; the disk layer is
            # disabled so later blocks do not retry the full write
            logger.warning("disabling tile spill cache: write failed (%s)", err)
            self._dir = None
            _unlink(path)
            return
        self._paths[key] = (path, size)
        self._used += size
        self._gen[key] = self.generation
        self.spills += 1


def _resolve_resident_bytes(resident_tile_bytes: int | None) -> int:
    """The resident budget: the argument, else ``YAWT_RESIDENT_TILE_BYTES``,
    else 4 GiB (the JAX package's default)."""
    if resident_tile_bytes is None:
        env = os.environ.get("YAWT_RESIDENT_TILE_BYTES")
        try:
            # malformed values (e.g. "4GB") degrade to the default: a broken
            # tuning knob must not abort a measurement
            resident_tile_bytes = int(env) if env and env.strip() else None
        except ValueError:
            logger.warning("ignoring malformed YAWT_RESIDENT_TILE_BYTES=%r", env)
            resident_tile_bytes = None
        if resident_tile_bytes is None:
            resident_tile_bytes = 4 << 30
    return resident_tile_bytes


def _make_tile_cache(
    stack: contextlib.ExitStack,
    tile_cache_bytes: int,
    resident_tile_bytes: int,
    *,
    store_rows: bool = False,
) -> _ColumnTileCache:
    """Construct a tile cache, registering its spill directory on the
    caller's exit stack. Spill location: ``YAWT_SPILL_DIR``, else the
    system temp dir (where ``/tmp`` is a RAM-backed tmpfs, point
    ``YAWT_SPILL_DIR`` at a disk)."""
    import tempfile

    cache_dir = None
    if tile_cache_bytes > 0:
        spill_root = os.environ.get("YAWT_SPILL_DIR") or None
        cache_dir = stack.enter_context(
            tempfile.TemporaryDirectory(prefix="yawt_blocked_tiles_", dir=spill_root)
        )
    return _ColumnTileCache(
        cache_dir, tile_cache_bytes, resident_tile_bytes, store_rows=store_rows
    )


# a ContextVar (not a process-global list) so the ambient scoping follows the
# context that opened the cache: a cache opened in one thread must not become
# the ambient cache of unrelated measurements running in other threads
_ACTIVE_CACHES: contextvars.ContextVar[tuple[_ColumnTileCache, ...]] = (
    contextvars.ContextVar("yawt_torch_active_tile_caches", default=())
)


def active_tile_cache() -> _ColumnTileCache | None:
    """The innermost ambient tile cache of the current context (see
    :func:`measurement_tile_cache`), or None."""
    stack = _ACTIVE_CACHES.get()
    return stack[-1] if stack else None


@contextlib.contextmanager
def measurement_tile_cache(
    tile_cache_bytes: int = 16 << 30,
    resident_tile_bytes: int | None = None,
):
    """A tile cache scoped to one or more measurements.

    Passed as ``cache=`` to several :func:`count_pairs_blocked` calls, the
    count types of one measurement share their packed (and, within the
    resident budget, uploaded) patch blocks: DD and RD of a
    cross-correlation both stream the unknown catalog as their column side,
    DD and DR both stream the reference as rows. While the context is open
    it is also the AMBIENT cache: blocked measurements started inside it
    (``max_resident_patches`` set) reuse it, so one reference catalog used
    by every tomographic bin's cross-correlation crosses to the card once
    per session::

        with measurement_tile_cache():
            for unknown in tomographic_bins:
                crosscorrelate(config, reference, unknown,
                               ref_rand=ref_rand, max_resident_patches=24)

    Catalogs are keyed weakly: the cache never extends their lifetime.
    """
    resident_tile_bytes = _resolve_resident_bytes(resident_tile_bytes)
    with contextlib.ExitStack() as stack:
        cache = _make_tile_cache(
            stack, tile_cache_bytes, resident_tile_bytes, store_rows=True
        )
        token = _ACTIVE_CACHES.set(_ACTIVE_CACHES.get() + (cache,))
        try:
            yield cache
        finally:
            _ACTIVE_CACHES.reset(token)
        logger.debug(
            "measurement tile cache: %d hits, %d rebuilds", cache.hits, cache.misses
        )


def count_pairs_blocked(
    edges: AngularEdges,
    linkage: Linkage,
    catalog1: Catalog,
    catalog2: Catalog,
    binning: Binning,
    *,
    auto: bool,
    binned2: bool,
    mode: str = "nn",
    max_resident_patches: int = 16,
    tile_size: int | None = None,
    backend: str = "auto",
    device: torch.device | str = "cuda",
    mesh=None,
    data_sharding: str = "replicated",
    progress: bool = False,
    tile_cache_bytes: int = 16 << 30,
    resident_tile_bytes: int | None = None,
    cache: _ColumnTileCache | None = None,
    audit: bool = False,
) -> np.ndarray:
    """Count pairs block by block; returns float64 per-scale counts of shape
    ``(num_scales, num_bins, num_patches, num_patches)`` (the contract of
    the in-memory engine path after its scatter).

    The engine runs on ``device`` (default ``"cuda"``, which raises when
    CUDA is not available); only ``backend="oracle"`` counts on the host.
    Column-block tile sets are cached at two levels (see
    :class:`_ColumnTileCache`): up to ``resident_tile_bytes`` (env
    ``YAWT_RESIDENT_TILE_BYTES``; default 4 GiB; 0 disables) of packed
    blocks stay on the card, so revisits skip the upload; blocks beyond
    that spill to a disk cache (capped at ``tile_cache_bytes``; 0 disables).
    Disk-cached catalogs also keep their packed blocks in a persistent
    :class:`~yet_another_wizz_tpu_torch.catalog.tilestore.PackedTileStore`.
    The host packs up to ``YAWT_PREFETCH_BLOCKS`` (default 1) upcoming
    blocks per side on worker threads, which on a CUDA device also queue
    their upload on a side stream, while the current block pair's kernels
    run. With ``cache=`` an externally created cache (see
    :func:`measurement_tile_cache`) is used as-is.

    ``audit=True`` runs the exact-boundary float64 repair per block pair
    (:func:`~yet_another_wizz_tpu_torch.ops.paircount.audit_boundary_counts`):
    each block pair is then counted synchronously with the union edges (no
    direct mode), and its repaired float64 counts are scattered on the host
    (no device accumulation, which would round them to float32).
    ``mesh`` and ``data_sharding`` are those of
    :func:`~yet_another_wizz_tpu_torch.ops.paircount.count_pairs_tiles`,
    resolved once for all block pairs; under a mesh the counts are
    scattered on the host and the device is the mesh's first of this
    process."""
    if backend == "oracle":
        mesh = None
    else:
        device = resolve_device(device)
        mesh = resolve_mesh(mesh, device)
    local = [] if mesh is None else mesh.local_shards()
    if local:
        device = resolve_device(mesh.devices[local[0]])
    tile_size = tile_size or DEFAULT_TILE_SIZE
    num_patches = catalog1.num_patches
    if catalog2.num_patches != num_patches:
        # blocks and the result shape derive from catalog1: a mismatched
        # catalog2 would silently drop its extra patches from the counts
        raise ValueError(
            "catalogs have different patch counts: "
            f"{num_patches} != {catalog2.num_patches}"
        )
    num_bins = len(binning)
    block = max(1, int(max_resident_patches) // 2)  # two resident sides
    starts = list(range(0, num_patches, block))

    # the in-memory engine's tile-layout policy: without it the per-tile
    # angular-cutoff pruning of the pair lists is ineffective
    layout1 = preferred_tile_layout(
        catalog1, num_bins, float(edges.max_angle),
        equal_bin_counting=binned2, tile_size=tile_size,
    )
    layout2 = (
        preferred_tile_layout(
            catalog2, num_bins, float(edges.max_angle),
            equal_bin_counting=True, tile_size=tile_size,
        )
        if binned2
        else "spatial"
    )

    indicator = None
    if progress:
        from yet_another_wizz_tpu_torch.utils.logging import Indicator

        indicator = iter(Indicator(range(len(starts) ** 2), len(starts) ** 2))

    result = np.zeros((edges.num_scales, num_bins, num_patches, num_patches))
    resident_tile_bytes = _resolve_resident_bytes(resident_tile_bytes)

    with contextlib.ExitStack() as stack:
        if cache is None:
            cache = active_tile_cache()
        own_cache = cache is None
        if (
            own_cache
            and (tile_cache_bytes > 0 or resident_tile_bytes > 0)
            and len(starts) > 1
        ):
            cache = _make_tile_cache(stack, tile_cache_bytes, resident_tile_bytes)
        _blocked_loop(
            edges, linkage, catalog1, catalog2, binning, starts, block,
            auto=auto, binned2=binned2, mode=mode, tile_size=tile_size,
            backend=backend, device=device, layout1=layout1, layout2=layout2,
            indicator=indicator, num_patches=num_patches, result=result,
            cache=cache, audit=audit, mesh=mesh, data_sharding=data_sharding,
        )
        if own_cache and cache is not None:
            logger.debug(
                "column tile cache: %d hits, %d rebuilds", cache.hits, cache.misses
            )
    return result


def scatter_block_scales(
    counts: torch.Tensor,
    scale_map: torch.Tensor,
    patch1: torch.Tensor,
    patch2: torch.Tensor,
    factor: torch.Tensor | None,
    accum: torch.Tensor,
) -> torch.Tensor:
    """Reduce one block pair's counts to scales and add them into the
    accumulator, on the counts' device (K2.3, the JAX package's
    ``_scatter_block_scales``, as plain torch ops).

    ``counts`` is the engine's ``(K, B, E)`` float32 cumulative output (one
    row per slot), ``scale_map`` the ``(B, E - 1, S)`` float32
    interval-to-scale table, ``patch1`` / ``patch2`` the ``(K,)`` int64
    global patch ids of the slots, ``factor`` None or ``(K,)`` float32 (0.5
    for the same-patch slots of an auto count, else 1), ``accum`` the
    ``(S, B, P, P)`` float32 accumulator, updated in place and returned.

    Everything is float32: the interval differences are exactly rounded
    subtractions of the float32 cumulatives, and the scale reduction sums a
    handful of non-negative terms per scale, as a broadcast multiply and
    sum (no matmul, so no TF32 setting reaches it). Each global patch pair
    lives in exactly one block pair and appears once in its list, so every
    accumulator element is written once per count: the result does not
    depend on the order of the adds."""
    intervals = counts[..., 1:] - counts[..., :-1]  # (K, B, E - 1)
    per_scale = (intervals[..., None] * scale_map).sum(dim=2)  # (K, B, S)
    if factor is not None:
        per_scale = per_scale * factor[:, None, None]
    accum.permute(2, 3, 0, 1).index_put_(
        (patch1, patch2), per_scale.permute(0, 2, 1), accumulate=True
    )
    return accum


PIPELINE_DEPTH = 8
"""Block pairs kept in flight: the card computes block pairs while the host
packs and loads the tiles of later ones; once this many are queued, the
host waits for the older half (and, with ``YAWT_DEVICE_ACCUMULATE=0``,
copies their counts to the host and scatters them)."""

def _blocked_loop(
    edges, linkage, catalog1, catalog2, binning, starts, block,
    *, auto, binned2, mode, tile_size, backend, device, layout1, layout2,
    indicator, num_patches, result, cache, audit=False, mesh=None,
    data_sharding="replicated",
) -> None:
    """The sweep over the block pairs of one count. Its phases are spans
    (:mod:`~yet_another_wizz_tpu_torch.utils.tracing`): ``blocked.preamble``,
    per block pair ``blocked.rows`` and ``blocked.cols`` (tile acquisition:
    cache or store load, or packing), ``blocked.pairs`` (the pair list) and
    ``blocked.queue`` (the engine's queueing), the drains' ``blocked.drain_wait``
    (waiting for the card), ``blocked.drain_fetch`` (copying results to the
    host) and ``blocked.drain_scatter`` (the host scatter), and
    ``blocked.teardown``. It counts ``blocked.block_pairs`` (engine calls)
    and, on a CUDA device, ``blocked.upload_bytes`` and ``blocked.upload_s``
    (the lane copies of the prefetch workers' side stream, timed by CUDA
    events around each copy). A debug log line sums the phases."""
    phases = {
        "rows": 0.0, "cols": 0.0, "pairs": 0.0, "queue": 0.0, "drain": 0.0,
        "drain_wait": 0.0, "drain_fetch": 0.0, "drain_scatter": 0.0,
        "upload": 0.0,
    }

    def timed(key, fn, *args, **kwargs):
        t0 = time.perf_counter()
        with span(f"blocked.{key}"):
            out = fn(*args, **kwargs)
        phases[key] += time.perf_counter() - t0
        return out

    with span("blocked.preamble"):
        on_card = backend != "oracle" and device.type == "cuda"
        # the counts are reduced and scattered on the device into one small
        # accumulator, fetched once per count; YAWT_DEVICE_ACCUMULATE=0 copies
        # each block pair's counts to the host and scatters them there, as do
        # the audit, whose repaired counts are float64 on the host, and a mesh
        device_accumulate = (
            backend != "oracle"
            and not audit
            and mesh is None
            and os.environ.get("YAWT_DEVICE_ACCUMULATE", "1").strip() != "0"
        )
        # per queued block pair: the event after its work on the card (None off
        # the card), then, without device accumulation, its host copy and slots
        pending: list = []

        def drain(keep: int) -> None:
            """Wait for the block pairs queued before the last ``keep`` and,
            without device accumulation, copy their counts to the host and
            scatter them into ``result``."""
            t0 = time.perf_counter()
            if len(pending) > keep:
                take = pending[: len(pending) - keep]
                del pending[: len(pending) - keep]
                with span("blocked.drain_wait"):
                    for item in take:
                        if item[0] is not None:
                            item[0].synchronize()
                t1 = time.perf_counter()
                phases["drain_wait"] += t1 - t0
                if not device_accumulate:
                    with span("blocked.drain_fetch"):
                        fetched = [item[1]() for item in take]
                    t2 = time.perf_counter()
                    phases["drain_fetch"] += t2 - t1
                    with span("blocked.drain_scatter"):
                        for (_, _, mapper, pairs, lo1, lo2), values in zip(
                            take, fetched
                        ):
                            per_scale = mapper.counts_to_scales(values)
                            global1 = pairs.slot_patches[:, 0] + lo1
                            global2 = pairs.slot_patches[:, 1] + lo2
                            if auto:
                                per_scale[:, global1 == global2, :] *= 0.5
                            result[:, :, global1, global2] += np.moveaxis(
                                per_scale, 1, -1
                            )
                    phases["drain_scatter"] += time.perf_counter() - t2
            phases["drain"] += time.perf_counter() - t0

        def queued_event():
            """An event after the work queued so far on the card (None off it)."""
            if not on_card:
                return None
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))
            return done

        def host_copy(cumulative):
            """Start copying one block pair's counts to the host; returns the
            callable that reads them as float64 once the copy is done."""
            if isinstance(cumulative, np.ndarray):  # oracle backend
                return lambda: cumulative
            if not on_card:
                return lambda: cumulative.numpy().astype(np.float64)
            host = torch.empty(
                cumulative.shape, dtype=cumulative.dtype, pin_memory=True
            )
            host.copy_(cumulative, non_blocking=True)
            return lambda: host.numpy().astype(np.float64)

        accum_state = {"accum": None, "scale_map": None}

        def queue_scatter(cumulative, mapper, pairs, lo1, lo2) -> None:
            """Queue the device reduction of one block pair's counts."""
            if accum_state["accum"] is None:
                accum_state["accum"] = torch.zeros(
                    result.shape, dtype=torch.float32, device=device
                )
                accum_state["scale_map"] = torch.from_numpy(
                    mapper.scale_maps.astype(np.float32)
                ).to(device)
            global1 = pairs.slot_patches[:, 0] + lo1
            global2 = pairs.slot_patches[:, 1] + lo2
            index = torch.from_numpy(np.stack([global1, global2]).astype(np.int64))
            index = index.to(device)
            factor = None
            if auto:
                factor = torch.from_numpy(
                    np.where(global1 == global2, 0.5, 1.0).astype(np.float32)
                ).to(device)
            scatter_block_scales(
                cumulative, accum_state["scale_map"], index[0], index[1], factor,
                accum_state["accum"],
            )

        # lanes of prefetched blocks are copied on a side stream, overlapping
        # the kernels queued on the current one (TileSet.device_data makes the
        # current stream wait for a copy before its first use); a mesh places
        # its lanes per call
        upload_stream = torch.cuda.Stream(device) if on_card and mesh is None else None
        uploads: list = []

        def warm_upload(tiles):
            if upload_stream is not None and tiles.device_upload(device) is None:
                tiles.device_data(device, stream=upload_stream)
                uploads.append((tiles.device_upload(device), tiles.lane_data.nbytes))
            return tiles

        # cache keys carry everything that shapes a block's tile set; catalogs
        # are keyed by weak identity (their data has no cheap content
        # fingerprint), the binning by value. Row blocks are admitted when the
        # cache is measurement-scoped (store_rows) or when both sides are
        # identical (autocorrelation-shaped counts).
        cache_rows = False
        row_base = col_base = None
        gen_token = None
        if cache is not None:
            binning_key = (binning.edges.tobytes(), str(binning.closed))
            row_base = (
                _WeakId(catalog1), binning_key, mode[0], layout1, block, tile_size,
            )
            col_base = (
                _WeakId(catalog2), binning_key if binned2 else None, mode[1],
                layout2, block, tile_size,
            )
            cache_rows = cache.store_rows or row_base == col_base
            gen_token = cache.begin_count()

        # persistent packed-tile stores: packed blocks are a pure function of
        # (catalog, binning, mode, layout, block size, tile size), so for
        # disk-cached catalogs they live next to the patch cache
        row_store = PackedTileStore.open(
            catalog1, binning, mode[0], layout1, block, tile_size
        )
        col_store = PackedTileStore.open(
            catalog2, binning if binned2 else None, mode[1], layout2, block, tile_size
        )

        def acquire(side: str, lo: int):
            """Load-or-build the tile set of one block (thread-safe: cache
            loads are read-only, ``load_block`` is a stateless read, cache
            stores happen in the main thread, store saves are atomic files).
            Returns the tiles and whether they still have to enter the
            session cache."""
            if side == "rows":
                use_cache, key = cache_rows, row_base
                store, catalog, side_binning = row_store, catalog1, binning
                side_mode, layout = mode[0], layout1
            else:
                use_cache, key = cache is not None, col_base
                store, catalog = col_store, catalog2
                side_binning = binning if binned2 else None
                side_mode, layout = mode[1], layout2
            if use_cache:
                tiles = cache.load(key + (lo,))
                if tiles is not None:
                    return warm_upload(tiles), False
            if store is not None:
                tiles = store.load(lo)
                if tiles is not None:
                    return warm_upload(tiles), True
            hi = min(lo + block, num_patches)
            tiles = _build_block_tiles(
                catalog, side_binning, side_mode, lo, hi, tile_size, layout=layout
            )
            if store is not None:
                store.save(lo, tiles)
            return warm_upload(tiles), True

        def qualifying_linkage(lo1, lo2):
            """The masked linked matrix of a block pair, or None when the pair
            contributes nothing: the single source of which block pairs run."""
            hi1 = min(lo1 + block, num_patches)
            hi2 = min(lo2 + block, num_patches)
            if auto and hi2 <= lo1:
                return None  # only patch pairs with id2 >= id1 contribute
            linked = linkage.linked[lo1:hi1, lo2:hi2]
            if auto:
                ids1 = np.arange(lo1, hi1)[:, None]
                ids2 = np.arange(lo2, hi2)[None, :]
                linked = linked & (ids2 >= ids1)
            return linked if linked.any() else None

        linked_by_pair = {
            (lo1, lo2): linked
            for lo1 in starts
            for lo2 in starts
            if (linked := qualifying_linkage(lo1, lo2)) is not None
        }
        pair_seq = list(linked_by_pair)
        sequences = {
            "rows": list(dict.fromkeys(lo1 for lo1, _ in pair_seq)),
            "cols": [lo2 for _, lo2 in pair_seq],
        }
        # up to ``YAWT_PREFETCH_BLOCKS`` blocks in flight per side; numpy
        # sorting and the native packer release the GIL, so up to two workers
        # per side run in parallel
        prefetch_depth = max(1, int(os.environ.get("YAWT_PREFETCH_BLOCKS", "1") or 1))
        executors = {
            side: ThreadPoolExecutor(
                max_workers=min(2, prefetch_depth),
                thread_name_prefix=f"yawt-{side}-pack",
            )
            for side in ("rows", "cols")
            if len(sequences[side]) > 1
        }
        futures: dict = {"rows": {}, "cols": {}}
        cursors = {"rows": 0, "cols": 0}

        def top_up(side: str) -> None:
            """Keep up to ``prefetch_depth`` futures outstanding on one side
            (main thread only). A cursor may pass a block whose future was
            consumed before its later duplicate position; the direct acquire
            then hits the resident cache."""
            if side not in executors:
                return
            sequence, pending_side = sequences[side], futures[side]
            while len(pending_side) < prefetch_depth and cursors[side] < len(sequence):
                lo = sequence[cursors[side]]
                cursors[side] += 1
                if lo not in pending_side:
                    pending_side[lo] = executors[side].submit(acquire, side, lo)

        def get_tiles(side: str, lo: int):
            """The tile set of one block, entered into the session cache when
            it was built or loaded from the store. In autocorrelation-shaped
            counts the twin of a block may have landed in the resident cache
            (uploaded) while a worker built it: that twin is preferred."""
            fut = futures[side].pop(lo, None)
            if fut is not None:
                tiles, built = timed(side, fut.result)
            else:
                tiles, built = timed(side, acquire, side, lo)
            use_cache = cache_rows if side == "rows" else cache is not None
            if built and use_cache:
                key = (row_base if side == "rows" else col_base) + (lo,)
                twin = None
                if cache_rows and row_base == col_base:
                    twin = cache.load(key, count=False, resident_only=True)
                if twin is not None:
                    tiles = twin
                else:
                    timed(side, cache.store, key, tiles)
            top_up(side)
            return tiles

        top_up("rows")
        top_up("cols")

        num_block_pairs = 0
        # direct separation-weighted counting when available (the oracle
        # backend and the audit require the union-edge representation); the
        # combined table is built once, not per block pair
        direct = edges.direct if backend != "oracle" and not audit else None
        if direct is not None:
            table, edges_radian, spec, mapper = (
                direct.combined_table(), direct.edges, direct.spec, direct
            )
        else:
            table, edges_radian, spec, mapper = (
                edges.chord2_table, edges.edges, None, edges
            )
        bin_max_angles = edges.edges.max(axis=1)

    try:
        for lo1 in starts:
            tiles1 = None  # acquired lazily: the block pair may be pruned
            for lo2 in starts:
                if indicator is not None:
                    next(indicator, None)
                linked = linked_by_pair.get((lo1, lo2))
                if linked is None:
                    continue
                if tiles1 is None:
                    tiles1 = get_tiles("rows", lo1)
                tiles2 = get_tiles("cols", lo2)

                # tile pairs with LOCAL patch ids; the auto diagonal is
                # already applied to the linked matrix
                local_linkage = type(linkage)(
                    max_angle=linkage.max_angle, linked=linked
                )
                pairs = timed(
                    "pairs", build_tile_pairs, tiles1, tiles2, local_linkage,
                    auto=False, bin_max_angles=bin_max_angles,
                )
                if pairs.num_pairs == 0:
                    continue
                num_block_pairs += 1
                count("blocked.block_pairs")
                # with audit, the block pair's repaired counts come back
                # synchronously as float64 host arrays
                cumulative = timed(
                    "queue", count_pairs_tiles, tiles1, tiles2, pairs, table,
                    backend=backend, device=device, edges_radian=edges_radian,
                    audit=audit, defer=True, direct=spec,
                    mesh="single" if mesh is None else mesh,
                    data_sharding=data_sharding,
                )
                if device_accumulate:
                    timed("queue", queue_scatter, cumulative, mapper, pairs, lo1, lo2)
                    pending.append((queued_event(),))
                else:
                    fetch = host_copy(cumulative)
                    pending.append(
                        (queued_event(), fetch, mapper, pairs, lo1, lo2)
                    )
                if len(pending) >= PIPELINE_DEPTH:
                    drain(PIPELINE_DEPTH // 2)

        drain(0)
        if accum_state["accum"] is not None:
            # the single result fetch of the accumulation mode
            t0 = time.perf_counter()
            with span("blocked.drain_wait"):
                done = queued_event()
                if done is not None:
                    done.synchronize()
            t1 = time.perf_counter()
            phases["drain_wait"] += t1 - t0
            with span("blocked.drain_fetch"):
                fetched = accum_state["accum"].cpu().numpy()
            t2 = time.perf_counter()
            phases["drain_fetch"] += t2 - t1
            with span("blocked.drain_scatter"):
                result += fetched.astype(np.float64)
            phases["drain_scatter"] += time.perf_counter() - t2
            phases["drain"] += time.perf_counter() - t0
    finally:
        # shut the prefetch workers down on every path: an exception
        # mid-sweep must not leak executors whose futures pin packed blocks
        with span("blocked.teardown"):
            for pool in executors.values():
                pool.shutdown(wait=True, cancel_futures=True)
            if gen_token is not None:
                cache.end_count(gen_token)
    if indicator is not None:
        next(indicator, None)  # prints the 100% line

    # the side-stream copies are done: every one was waited for before its
    # lanes were read, and the final drain waited for the card
    for (start, stop), nbytes in {id(u[0]): u for u in uploads}.values():
        stop.synchronize()
        seconds = start.elapsed_time(stop) / 1e3
        phases["upload"] += seconds
        count("blocked.upload_s", seconds)
        count("blocked.upload_bytes", nbytes)

    logger.debug(
        "processed %d resident block pairs of <=%d patches (rows %.2fs, "
        "cols %.2fs, pair lists %.2fs, queue %.2fs, drain %.2fs = wait "
        "%.2fs + fetch %.2fs + scatter %.2fs, uploads %.3fs on the card)",
        num_block_pairs, block, phases["rows"], phases["cols"],
        phases["pairs"], phases["queue"], phases["drain"],
        phases["drain_wait"], phases["drain_fetch"], phases["drain_scatter"],
        phases["upload"],
    )

"""Persistent packed-tile cache attached to a catalog's cache directory.

Ported from the JAX package's ``catalog/tilestore.py``. The packed tile
sets the blocked engine streams to the device are a pure function of
(catalog data, binning, counting mode, tile layout, block decomposition),
so for a disk-cached catalog they are persisted next to the patch cache,
keyed by a fingerprint of everything that shapes them: a measurement over a
cached catalog then streams disk -> device without repacking. This mirrors
the reference's binning-fingerprinted tree cache
(yaw/catalog/trees.py:442-447,519-524), with several fingerprints retained.

Layout on disk::

    <cache_directory>/tiles/<fingerprint>/block_<patch_lo>.npz

Each ``.npz`` holds the field set of this package's
:class:`~yet_another_wizz_tpu_torch.ops.tiles.TileSet` (float32 lanes, no
fixed-point fields; the same serialisation the blocked path's spill cache
uses). The fingerprint embeds :data:`TILE_STORE_FORMAT`, a tag of this
package's own: a ``tiles/`` store the JAX package wrote into a shared cache
directory hashes to other directories, so it is never read here, only
missed. The data part of the fingerprint is taken from the cache's own
files (each patch's ``meta.yml`` bytes and ``data.bin`` size), so a
:class:`~yet_another_wizz_tpu_torch.catalog.catalog.Catalog` and a
:class:`~yet_another_wizz_tpu_torch.catalog.lazy.LazyCatalog` over one
cache share a store, and a re-ingested cache gets a new one.

Writes go through a temp file + atomic rename, so concurrent measurements
(threads or processes) can share a store without locking. Stale
fingerprint directories are pruned oldest-first beyond
:data:`MAX_FINGERPRINTS`. ``YAWT_TILE_STORE=0`` disables the store.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import tempfile
import threading
import zipfile
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from yet_another_wizz_tpu_torch.utils.tracing import count

if TYPE_CHECKING:
    from yet_another_wizz_tpu_torch.binning import Binning
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

__all__ = [
    "PackedTileStore",
    "TILE_SET_ARRAYS",
    "TILE_SET_SCALARS",
    "tileset_from_payload",
    "tileset_payload",
]

logger = logging.getLogger(__name__)

TILE_STORE_FORMAT = "yet_another_wizz_tpu_torch/1"
"""Changed whenever the TileSet field set or packing semantics change: the
fingerprint embeds it, so stale stores (and the JAX package's) are missed,
not misread."""

MAX_FINGERPRINTS = 4
"""Fingerprint directories retained per store."""

TILE_SET_SCALARS = ("num_bins", "num_points", "tile_size")
TILE_SET_ARRAYS = (
    "lane_data", "tile_patch", "tile_center", "tile_radius",
    "patch_tile_start", "patch_tile_stop", "sum_weights", "tile_zmin",
    "tile_zmax",
)


def tileset_payload(tiles: TileSet) -> dict:
    """The npz payload serialising one tile set (shared by the persistent
    store and the blocked path's spill cache)."""
    payload = {name: getattr(tiles, name) for name in TILE_SET_ARRAYS}
    payload.update(
        {name: np.asarray(getattr(tiles, name)) for name in TILE_SET_SCALARS}
    )
    if tiles.sum_kappa is not None:
        payload["sum_kappa"] = tiles.sum_kappa
    return payload


def tileset_from_payload(payload) -> TileSet:
    """Rebuild a :class:`TileSet` from a (possibly lazily mapped) npz
    payload."""
    from yet_another_wizz_tpu_torch.ops.tiles import TileSet

    fields = {name: payload[name] for name in TILE_SET_ARRAYS}
    fields.update({name: payload[name].item() for name in TILE_SET_SCALARS})
    fields["sum_kappa"] = payload["sum_kappa"] if "sum_kappa" in payload else None
    return TileSet(**fields)


def _store_enabled() -> bool:
    return os.environ.get("YAWT_TILE_STORE", "1").strip() != "0"


def _cache_fingerprint(cache_dir: Path, num_patches: int) -> bytes | None:
    """The bytes of every patch's ``meta.yml`` with the size of its
    ``data.bin``, or None when a patch's files are missing."""
    parts = []
    for pid in range(num_patches):
        patch_dir = cache_dir / f"patch_{pid}"
        try:
            parts.append((patch_dir / "meta.yml").read_bytes())
            parts.append(str((patch_dir / "data.bin").stat().st_size).encode())
        except OSError:
            return None
    return b"\x00".join(parts)


class PackedTileStore:
    """One catalog-side store for one block-tiling configuration.

    Opened per blocked count via :meth:`open`; ``None`` when the catalog
    has no cache directory (in-memory data has no durable home and the
    session caches already cover repeated measurements) or the store is
    disabled. ``load``/``save`` are thread-safe through filesystem
    atomicity — save never overwrites and load treats any unreadable file
    as a miss. ``hits`` / ``misses`` count the loads, as do the counters
    ``cache.hit.store`` / ``cache.miss.store``.
    """

    def __init__(self, directory: Path, fingerprint: str) -> None:
        self._root = Path(directory)
        self._dir = self._root / fingerprint
        self._fingerprint = fingerprint
        self._disabled = False
        self._stats_lock = threading.Lock()  # loads run on prefetch threads
        self.hits = 0
        self.misses = 0

    def _count(self, hit: bool) -> None:
        with self._stats_lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
            count("cache.hit.store" if hit else "cache.miss.store")

    @classmethod
    def open(
        cls,
        catalog,
        binning: Binning | None,
        mode: str,
        layout: str,
        block: int,
        tile_size: int,
    ) -> PackedTileStore | None:
        """A store for ``catalog`` under the given tiling configuration, or
        None when the catalog is not disk-cached, its cache files are
        incomplete, or the store is off.

        The fingerprint covers :data:`TILE_STORE_FORMAT`, every parameter
        that shapes the packed blocks, the catalog's column layout and the
        cache's own patch files (see the module docstring): a changed
        binning, layout or block size, or a re-ingested cache, each hash to
        a fresh directory, so stale blocks are never served."""
        cache_dir = getattr(catalog, "cache_directory", None)
        if cache_dir is None or not _store_enabled():
            return None
        cache_dir = Path(cache_dir)
        data = _cache_fingerprint(cache_dir, catalog.num_patches)
        if data is None:
            return None
        hasher = hashlib.sha256()

        def feed(part) -> None:
            hasher.update(part if isinstance(part, bytes) else str(part).encode())
            hasher.update(b"\x00")

        feed(TILE_STORE_FORMAT)
        if binning is None:
            feed("unbinned")
        else:
            feed(binning.edges.tobytes())
            feed(binning.closed)
        feed(mode)
        feed(layout)
        feed(block)
        feed(tile_size)
        feed(catalog.num_patches)
        feed((catalog.has_weights, catalog.has_redshifts, catalog.has_kappa))
        feed(data)
        return cls(cache_dir / "tiles", hasher.hexdigest()[:20])

    def _path(self, patch_lo: int) -> Path:
        return self._dir / f"block_{patch_lo}.npz"

    def load(self, patch_lo: int) -> TileSet | None:
        """The stored tile set for the block starting at ``patch_lo``, or
        None. A file that cannot be read as a tile set (torn by a crashed
        writer) is a miss and is removed."""
        path = self._path(patch_lo)
        try:
            with np.load(path) as payload:
                tiles = tileset_from_payload(payload)
        except FileNotFoundError:
            self._count(hit=False)
            return None
        except (OSError, EOFError, ValueError, KeyError, zipfile.BadZipFile) as err:
            logger.warning("dropping unreadable packed-tile block %s (%s)", path, err)
            path.unlink(missing_ok=True)
            self._count(hit=False)
            return None
        self._count(hit=True)
        return tiles

    def save(self, patch_lo: int, tiles: TileSet) -> None:
        """Persist one packed block (atomic; never overwrites a block a
        concurrent writer landed first). A failed write — e.g. a full disk
        — disables this store instance rather than failing the measurement
        or retrying on every block."""
        if self._disabled:
            return
        path = self._path(patch_lo)
        if path.exists():
            return
        try:
            self._dir.mkdir(parents=True, exist_ok=True)
            self._prune_stale()
            fd, tmp = tempfile.mkstemp(dir=self._dir, prefix=path.stem, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **tileset_payload(tiles))
                os.replace(tmp, path)
            except BaseException:
                Path(tmp).unlink(missing_ok=True)
                raise
        except OSError as err:
            logger.warning(
                "disabling packed-tile store %s: write failed (%s)", self._dir, err
            )
            self._disabled = True

    def _prune_stale(self) -> None:
        """Drop the oldest fingerprint directories beyond
        :data:`MAX_FINGERPRINTS` (the active fingerprint is always kept).
        A directory's mtime tracks its last save."""
        try:
            others = [
                entry
                for entry in self._root.iterdir()
                if entry.is_dir() and entry.name != self._fingerprint
            ]
        except OSError:
            return
        if len(others) < MAX_FINGERPRINTS:
            return
        others.sort(key=lambda entry: entry.stat().st_mtime)
        for entry in others[: len(others) - (MAX_FINGERPRINTS - 1)]:
            logger.info("pruning stale packed-tile cache %s", entry)
            shutil.rmtree(entry, ignore_errors=True)
